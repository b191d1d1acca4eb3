"""The device's idle share of the profiled stretch, in %: 1 - (the union
of its operations' intervals / the stretch from the first profiled job's
start to the last one's end)."""


def read(record):
    tr = record["trace"]
    if not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
