"""The train step's kernels against their roofline: the least time of the
step's model work (arith.step_flops at the bf16 peak) over the device time
of every operation in the step, whichever kernels do the work."""
from port_bench.arith import PEAK_BF16_FLOPS


def read(summary, work):
    t = sum(summary["kernels"].values())
    if t <= 0 or not work.get("step_flops"):
        return None
    return 100.0 * work["step_flops"] / PEAK_BF16_FLOPS / t
