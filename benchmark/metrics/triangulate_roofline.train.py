"""Share (%) of the triangulation kernel's device time that the larger of
its bytes bound and its float32 operations bound needs, for one
triangulation of the step's G x J points over V views."""
from benchmark import rooflines
from benchmark.readers import group_s_per_call


def read(record):
    s = group_s_per_call(record, "triangulate")
    if s is None:
        return None
    mix = record["mix"]
    n_bytes, ops = rooflines.triangulate_work(
        int(mix["groups"]), int(mix["views"]), record["arch"]["num_joints"])
    return 100.0 * rooflines.bound_s(n_bytes, ops) / s
