"""Host clock from ``api.render``'s call to its return, before the
synchronize that follows: the enqueue time plus the program's own syncs,
a frame, over untraced frames."""


def read(record):
    return record.get("host_ms_per_frame")
