"""Share (%) of the card's bf16 dense peak (989 TFLOP/s) that the
window's rate reaches on two forwards a sample (the flip test)."""
from benchmark import rooflines
from benchmark.readers import rate


def read(record):
    return (100.0 * record["flops_per_sample"] * rate(record)
            / rooflines.BF16_TENSOR_FLOPS)
