"""Device idle time a frame in the render loop's own stages: the idle gaps
of the traced window whose innermost program span at the gap's middle is
``lt.frame``, ``lt.camera``, ``lt.bounce``, ``lt.nee`` or ``lt.record``
(the host launching, or waiting on a readback, outside the queries)."""

from ltbench import program_spans


def read(record):
    return program_spans.idle_ms_per_frame(record, program_spans.LOOP)
