"""The device's idle share of the recorded jobs, in %: one less the union
of its operations' intervals over the recorded window (from the first
recorded job's start to the last one's end), both from one profiler
recording."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
