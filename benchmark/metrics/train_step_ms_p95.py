"""95th percentile (nearest rank) of the intervals between consecutive
steps' ends, from CUDA events recorded after each step and read after the
window; None off the card."""
from benchmark.window import p95


def read(record):
    gaps = record.get("end_gaps_ms")
    return p95(gaps) if gaps else None
