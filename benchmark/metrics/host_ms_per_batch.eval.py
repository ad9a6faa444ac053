"""Mean host milliseconds of a call into the program's eval step plus
the copy of its predictions to the host, from the benchmark's spans in
the unprofiled window."""


def read(record):
    host = record["host_s"]
    return 1e3 * sum(host) / len(host)
