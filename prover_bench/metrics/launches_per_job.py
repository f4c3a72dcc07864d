"""Device operations (kernels, copies and memsets) in the recording, a
recorded job."""


def read(run):
    p = run.profile
    if p is None or not p["jobs"]:
        return None
    return p["launches"] / p["jobs"]
