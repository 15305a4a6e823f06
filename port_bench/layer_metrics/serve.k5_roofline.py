"""K5's share of its roofline in a served frame: the least time of K5's
calls at the frame's points (arith.frame_work) over the device time of its
launches, the bf16 field tile and the compositing (float32: the SIMT
level kernel)."""
from port_bench.arith import base_name

LAUNCHES = ("field_tc_kernel", "composite_fwd_kernel", "nerf_level_kernel")


def read(summary, work):
    t = sum(s for n, s in summary["kernels"].items() if base_name(n) in LAUNCHES)
    if t <= 0 or not work.get("k5_s"):
        return None
    return 100.0 * work["k5_s"] / t
