"""The Cairo frontend: seconds of the VM, the host trace build and the
ingest to the card (`trace._timings`), a trace, averaged over the cell's
traces."""


def read(run):
    per = [sum(t.timings.get(k, 0.0) for k in ("vm", "trace_build", "ingest"))
           for t in run.traces]
    return sum(per) / len(per) if per else None
