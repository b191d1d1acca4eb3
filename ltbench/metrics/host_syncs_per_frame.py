"""Host syncs of one frame, as torch reports them in sync debug mode
"warn" (the run prints them by file and line)."""


def read(record):
    return record.get("syncs_per_frame")
