"""The whole frame's share of the card's bf16 peak: the model's products,
each net once a point (arith.frame_work), over the traced seconds a frame."""
from port_bench.arith import PEAK_BF16_FLOPS


def read(summary, work):
    if summary["busy_s"] <= 0 or summary["window_s"] <= 0 or not work.get("model_flops"):
        return None
    return 100.0 * work["model_flops"] / (summary["window_s"] / summary["items"] * PEAK_BF16_FLOPS)
