"""Share (%) of the soft-argmax forward kernel's device time that its
bytes bound needs: the averaged flip-test volume read once, the
coordinates written once, at 3.35 TB/s."""
from benchmark import rooflines
from benchmark.readers import group_s_per_call, heatmap_shape


def read(record):
    fwd = group_s_per_call(record, "softargmax_fwd")
    if fwd is None:
        return None
    need = rooflines.bound_s(
        rooflines.softargmax_fwd_bytes(*heatmap_shape(record)))
    return 100.0 * need / fwd
