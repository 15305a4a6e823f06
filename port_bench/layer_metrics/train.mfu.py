"""The whole train step's share of the card's bf16 peak: the step's model
operations (arith.step_flops: forward once, backward twice) over the
traced seconds a step."""
from port_bench.arith import PEAK_BF16_FLOPS


def read(summary, work):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0 or not work.get("step_flops"):
        return None
    return 100.0 * work["step_flops"] / (summary["window_s"] / summary["items"] * PEAK_BF16_FLOPS)
