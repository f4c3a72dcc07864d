"""Seconds a job: the window over the jobs completed in it (host clock).
The window opens as the first job starts and ends as the last one's proof
is on the host, so no job is cut."""


def read(run):
    done = [j for j in run.jobs if j.proof is not None]
    return run.window_s / len(done) if done else None
