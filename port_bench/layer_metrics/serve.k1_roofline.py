"""K1's share of its roofline in a served frame: the least time of the
deformation pair's calls at the frame's points (arith.frame_work) over the
device time of its launches."""
from port_bench.arith import base_name

LAUNCHES = ("deform_pair_wg_kernel", "deform_pair_kernel")


def read(summary, work):
    t = sum(s for n, s in summary["kernels"].items() if base_name(n) in LAUNCHES)
    if t <= 0 or not work.get("k1_s"):
        return None
    return 100.0 * work["k1_s"] / t
