"""Per-rank frame sharding for multi-process training (counterpart of
``sahs_tpu/data/sharded.py``).

The training semantics stay the reference's: every step draws its rays
from ONE frame that all ranks agree on, while each rank decodes only its
own shard of the frames:

  - frame ownership is round-robin: rank h owns frames {i : i % H == h};
  - the per-step frame schedule comes from a shared seed (numpy's
    ``RandomState``, so it is bit-equal to the JAX package's), and every
    process computes the same sequence without communication;
  - the stacked (K, ...) batch of the multi-step loop is assembled by
    broadcasting each slot's frame from the rank that owns it, in place of
    ``jax.make_array_from_process_local_data`` and XLA's broadcast inside
    the scan (sharded.py:132-154).

On one process everything is plain stacking.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def shard_indices(n_frames: int, process_index: int,
                  process_count: int) -> List[int]:
    """Round-robin frame ownership: rank h owns {i : i % H == h}."""
    if not (0 <= process_index < process_count):
        raise ValueError(f"process_index {process_index} out of range "
                         f"[0, {process_count})")
    return list(range(process_index, n_frames, process_count))


class HostShardedFrames:
    """Decodes, lazily, only the frames this rank owns.

    Wraps any indexable dataset (NerfaceDataset, AudioDataset,
    SyntheticFaceDataset). Access is by global frame index; touching a
    frame another rank owns raises (it would break the "each rank loads
    its shard" contract)."""

    def __init__(self, dataset, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.process_index = process_index
        self.process_count = process_count
        self.owned = set(shard_indices(len(dataset), process_index,
                                       process_count))
        self._cache: Dict[int, Any] = {}
        self.decode_count = 0

    def __len__(self):
        return len(self.dataset)

    def get(self, global_idx: int):
        if global_idx not in self.owned:
            raise KeyError(
                f"frame {global_idx} is owned by rank "
                f"{global_idx % self.process_count}, not rank "
                f"{self.process_index}")
        if global_idx not in self._cache:
            self._cache[global_idx] = self.dataset[global_idx]
            self.decode_count += 1
        return self._cache[global_idx]


def frame_schedule(seed: int, n_frames: int, num_steps: int) -> np.ndarray:
    """Per-step frame indices, the same on every process (the multi-process
    form of the reference's ``np.random.choice(len(dataset))``,
    train_stage_rays_auto.py:327)."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, n_frames, size=(num_steps,)).astype(np.int64)


def blocked_frame_schedule(seed: int, n_frames: int, num_steps: int,
                           process_count: int) -> np.ndarray:
    """The schedule of one launch of ``num_steps`` steps: slot t is filled
    from the shard of rank h = t * H // num_steps (contiguous blocks, as
    the JAX package's sharding of the step axis partitions it), each
    frame drawn uniformly within its rank's shard; the same on every
    process. As the JAX package's, this differs from the reference's
    uniform draw over all frames in the order of the steps, not in the
    frames' coverage."""
    if num_steps % process_count:
        raise ValueError(f"num_steps {num_steps} must be a multiple of "
                         f"process_count {process_count}")
    rng = np.random.RandomState(seed)
    per = num_steps // process_count
    out = np.empty((num_steps,), np.int64)
    for h in range(process_count):
        shard = np.asarray(shard_indices(n_frames, h, process_count))
        out[h * per:(h + 1) * per] = shard[rng.randint(0, len(shard),
                                                       size=(per,))]
    return out


def owned_slots(schedule: Sequence[int], process_index: int,
                process_count: int) -> List[int]:
    """The slots of a blocked schedule this rank fills: its contiguous
    block."""
    per = len(schedule) // process_count
    return list(range(process_index * per, (process_index + 1) * per))


def _frame_tensors(item) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in item.items()
            if k != "fname"}


def assemble_sharded_batches(frames: HostShardedFrames,
                             schedule: Sequence[int],
                             background: Optional[np.ndarray] = None,
                             group=None, device=None) -> Dict[str, torch.Tensor]:
    """The stacked (K, ...) batch of ``train/stage1.make_multi_train_step``
    for ``schedule``, on ``device`` (CUDA unless the caller names another;
    with no device given and no CUDA present this raises).

    One process (``group`` None or of one rank): plain stacking of every
    slot's frame. Several: the rank that owns a slot's frame (f % H; under
    a blocked schedule the rank whose block holds the slot) decodes it and
    broadcasts it to every rank; a rank decodes only frames it owns.
    ``background`` (H, W, 15), which every rank holds, is broadcast along
    K as a view."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    K = len(schedule)
    if group is None or group.world == 1:
        items = [_frame_tensors(frames.get(int(f)) if int(f) in frames.owned
                                else frames.dataset[int(f)]) for f in schedule]
        out = {k: torch.stack([it[k] for it in items]).to(dev) for k in items[0]}
    else:
        if not frames.owned:
            raise ValueError(f"rank {group.rank} owns none of the "
                             f"{len(frames)} frames")
        # a frame's shapes and types, from one this rank owns: every frame
        # of a dataset has the same
        template = _frame_tensors(frames.get(min(frames.owned)))
        out = {k: torch.empty((K,) + tuple(v.shape), dtype=v.dtype, device=dev)
               for k, v in template.items()}
        for t, f in enumerate(schedule):
            owner = int(f) % frames.process_count
            if owner == group.rank:
                for k, v in _frame_tensors(frames.get(int(f))).items():
                    out[k][t].copy_(v)
            for k in out:
                group.broadcast_(out[k][t], src=owner)
    if background is not None:
        bg = (background if torch.is_tensor(background)
              else torch.as_tensor(np.asarray(background))).to(dev, torch.float32)
        out["background"] = bg.expand((K,) + tuple(bg.shape))
    return out
