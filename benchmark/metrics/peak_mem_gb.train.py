"""Peak GB the process held on the card during the window
(``max_memory_allocated`` after ``reset_peak_memory_stats`` at its
start)."""


def read(record):
    return record["peak_bytes"] / 1e9 if record["peak_bytes"] else None
