"""95th percentile (nearest rank) over the window's batches of the time
from handing a batch to the step until its predictions are on the host:
CUDA events recorded before the call and after the copy, read after the
window; None off the card."""
from benchmark.window import p95


def read(record):
    spans = record.get("call_ms")
    return p95(spans) if spans else None
