"""Device time a frame of the operations launched inside the program's
``lt.bounce`` spans (each bounce of the path tracer) and outside its
``lt.query.*`` spans: the bounce's own shading, sampling, emission and
NEE arithmetic, its copies included, without the intersection queries."""

from ltbench import program_spans


def read(record):
    return program_spans.device_ms_per_frame(
        record, ("lt.bounce",), ("lt.query.nearest", "lt.query.any"))
