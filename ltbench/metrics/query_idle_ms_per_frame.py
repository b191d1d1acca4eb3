"""Device idle time a frame in the intersection queries: the idle gaps of
the traced window whose innermost program span at the gap's middle is
``lt.query.nearest``, ``lt.query.any``, ``lt.sort`` or ``lt.isect``."""

from ltbench import program_spans


def read(record):
    return program_spans.idle_ms_per_frame(record, program_spans.QUERY)
