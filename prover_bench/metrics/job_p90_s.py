"""The 90th percentile of the latency of every job in the window (host
clock; interpolated between ranks)."""

import statistics


def read(run):
    lat = [j.end - j.start for j in run.jobs if j.proof is not None]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[8]
