"""The share of the traced frames in which no operation ran on the card."""


def read(summary, work):
    if summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
