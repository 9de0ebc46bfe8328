"""setup_s: seconds from the process's start to the window's start (the
kernels' build or load, the clip, the host encode and staging, the
warm-up)."""


def read(run):
    return run.setup_s
