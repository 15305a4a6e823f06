"""Scalar and image metric logging (a copy of ``sahs_tpu/utils/logging.py``;
the port never imports the JAX package).

The reference logs inline to a SummaryWriter (train_stage_rays_auto.py:228,
517-694). Every record goes to ``metrics.jsonl`` in the log directory;
TensorBoard gets it too where ``torch.utils.tensorboard`` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np


class MetricLogger:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(logdir)
        except Exception:   # tensorboard missing or broken: JSON lines only
            self._tb = None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            v = float(v)
            rec[k] = v
            if self._tb is not None:
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        if self._tb is not None:
            arr = np.clip(np.asarray(img), 0, 1)
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
