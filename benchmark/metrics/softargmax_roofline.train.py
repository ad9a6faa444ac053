"""Share (%) of the soft-argmax forward and backward kernels' device
time that their bytes bound needs: each volume read once and the outputs
written once, at 3.35 TB/s."""
from benchmark import rooflines
from benchmark.readers import group_s_per_call, heatmap_shape


def read(record):
    fwd = group_s_per_call(record, "softargmax_fwd")
    bwd = group_s_per_call(record, "softargmax_bwd")
    if fwd is None or bwd is None:
        return None
    shape = heatmap_shape(record)
    need = rooflines.bound_s(rooflines.softargmax_fwd_bytes(*shape)
                             + rooflines.softargmax_bwd_bytes(*shape))
    return 100.0 * need / (fwd + bwd)
