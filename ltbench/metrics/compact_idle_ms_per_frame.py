"""Device idle time a frame in tail compaction: the idle gaps of the
traced window whose innermost program span at the gap's middle is
``lt.compact`` (the live-count readback and the shrink to the new
width)."""

from ltbench import program_spans


def read(record):
    return program_spans.idle_ms_per_frame(record, program_spans.COMPACT)
