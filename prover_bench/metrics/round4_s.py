"""Round 4 of the prover (DEEP, the FRI commit chain, grinding and the
query openings): `proof._timings["round4"]` averaged over the window's jobs
that the profiler did not record (all of them where it recorded every
one)."""


def read(run):
    jobs = [j for j in run.jobs if j.proof is not None]
    plain = [j for j in jobs if not j.recorded] or jobs
    vals = [j.timings["round4"] for j in plain if "round4" in j.timings]
    return sum(vals) / len(vals) if vals else None
