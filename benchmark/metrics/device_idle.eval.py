"""Share (%) of the profiled stretch in which no kernel, copy or memset
ran on the card (the frozen trace summary)."""


def read(record):
    t = record.get("trace")
    return None if not t else 100.0 * (1.0 - t["busy_s"] / t["window_s"])
