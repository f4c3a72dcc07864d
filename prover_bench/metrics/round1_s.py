"""Round 1 of the prover (both trace commitments and the RAP build):
`proof._timings["round1"]` averaged over the window's jobs that the
profiler did not record (all of them where it recorded every one)."""


def read(run):
    jobs = [j for j in run.jobs if j.proof is not None]
    plain = [j for j in jobs if not j.recorded] or jobs
    vals = [j.timings["round1"] for j in plain if "round1" in j.timings]
    return sum(vals) / len(vals) if vals else None
