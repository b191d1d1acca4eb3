"""Device time a frame of the operations launched inside the program's
``lt.sort`` spans (``ops.raysort.sorted_apply``) and outside its
``lt.isect`` spans: the sort keys, the argsort, the permutations of the
rays and of the results."""

from ltbench import program_spans


def read(record):
    return program_spans.device_ms_per_frame(record, ("lt.sort",),
                                             ("lt.isect",))
