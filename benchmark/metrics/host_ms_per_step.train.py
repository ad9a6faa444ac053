"""Mean host milliseconds of a call into the program's train step, from
the benchmark's spans around each call in the unprofiled window (the
loss read every PRINT_FREQ steps included)."""


def read(record):
    host = record["host_s"]
    return 1e3 * sum(host) / len(host)
