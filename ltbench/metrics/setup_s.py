"""Seconds from the process start to the first timed job: imports, the
kernels loaded (or built, in a checkout's first run), the scene built and
the warm-up jobs."""


def read(record):
    return record["setup_s"]
