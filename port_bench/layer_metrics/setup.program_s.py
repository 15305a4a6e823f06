"""The program's own seconds of set-up: its ``setup.*`` phases (the kernel
libraries hashed or built, ``setup.kernels``; the model built,
``setup.model``) and the first frame (``serve.frame``'s first call: the
libraries loaded, the first launches and the first calls of every op),
from the program's phase aggregates
(``sahs_tpu_torch.utils.profiling.snapshot``). The rest of ``setup_s`` is
the imports, the card's context, the harness's weights and inputs and the
other warm-up frames. Nothing without a traced slice, or from a program
that has no such phases."""


def read(summary, work):
    if summary.get("busy_s", 0.0) <= 0:
        return None
    try:
        from sahs_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    phases = snapshot()["phases"]
    frame = phases.get("serve.frame")
    if frame is None:
        return None
    return frame["first_s"] + sum(p["total_s"] for name, p in phases.items()
                                  if name.startswith("setup."))
