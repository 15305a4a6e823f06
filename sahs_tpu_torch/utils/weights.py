"""Weights from the JAX package's parameter tree.

``params_from_jax`` takes the tree ``init_model_params`` (nerface.py:110-124
of the JAX package) returns, or a checkpoint's, converted to numpy arrays,
and loads it into a ``NeRFaceModel``. Two layout changes:
  - a linear layer's ``w`` is (in, out); ``nn.Linear.weight`` is (out, in);
  - AudioNet's conv ``w`` is (k, cin, cout) for NWC data (fields.py:338-351);
    ``nn.Conv1d.weight`` is (cout, cin, k) for NCW data.
``params_to_jax`` goes back, for round-trip checks, and ``grads_to_jax``
maps the ``.grad`` fields onto the same tree, so that gradients compare
leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from ..models.nerface import NeRFaceModel


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load_linear(lin: nn.Linear, p: Dict[str, Any]) -> None:
    with torch.no_grad():
        lin.weight.copy_(_t(p["w"]).t())
        lin.bias.copy_(_t(p["b"]))


def _load_linears(mods, ps) -> None:
    if len(mods) != len(ps):
        raise ValueError(f"layer count {len(ps)} != {len(mods)}")
    for m, p in zip(mods, ps):
        _load_linear(m, p)


def params_from_jax(model: NeRFaceModel, tree: Dict[str, Any]) -> NeRFaceModel:
    """Load the JAX parameter tree (numpy leaves) into ``model`` in place."""
    for name in ("warp", "hyper"):
        net = getattr(model, name)
        if net is not None:
            _load_linears(net.trunk.layers, tree[name]["trunk"])
            _load_linear(net.out, tree[name]["out"])
    for level in ("coarse", "fine"):
        net = getattr(model, level)
        if net is None:
            continue
        p = tree[level]
        _load_linears(net.trunk.layers, p["trunk"])
        for key in ("fc_feat", "fc_alpha", "fc_rgb", "fc_seg"):
            _load_linear(getattr(net, key), p[key])
        _load_linears(net.dir, p["dir"])
        _load_linears(net.seg, p["seg"])
    with torch.no_grad():
        if model.spatial_embeddings is not None:
            model.spatial_embeddings.copy_(_t(tree["spatial_embeddings"]))
        if model.audnet is not None:
            a = tree["audnet"]
            for conv, p in zip(model.audnet.convs, a["convs"]):
                conv.weight.copy_(_t(p["w"]).permute(2, 1, 0))
                conv.bias.copy_(_t(p["b"]))
            _load_linear(model.audnet.fc1, a["fc1"])
            _load_linear(model.audnet.fc2, a["fc2"])
    return model


def params_to_jax(model: NeRFaceModel, get=lambda p: p) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a tree of numpy arrays.
    ``get`` maps each parameter to the tensor taken (default: itself)."""
    def np_(p):
        return get(p).detach().cpu().numpy()

    def _lin(lin: nn.Linear) -> Dict[str, np.ndarray]:
        return {"w": np_(lin.weight).T, "b": np_(lin.bias)}

    tree: Dict[str, Any] = {}
    for name in ("warp", "hyper"):
        net = getattr(model, name)
        if net is not None:
            tree[name] = {"trunk": [_lin(l) for l in net.trunk.layers],
                          "out": _lin(net.out)}
    for level in ("coarse", "fine"):
        net = getattr(model, level)
        if net is None:
            continue
        tree[level] = {
            "trunk": [_lin(l) for l in net.trunk.layers],
            "fc_feat": _lin(net.fc_feat), "fc_alpha": _lin(net.fc_alpha),
            "dir": [_lin(l) for l in net.dir], "fc_rgb": _lin(net.fc_rgb),
            "seg": [_lin(l) for l in net.seg], "fc_seg": _lin(net.fc_seg)}
    if model.spatial_embeddings is not None:
        tree["spatial_embeddings"] = np_(model.spatial_embeddings)
    if model.audnet is not None:
        a = model.audnet
        tree["audnet"] = {
            "convs": [{"w": np_(c.weight).transpose(2, 1, 0),
                       "b": np_(c.bias)} for c in a.convs],
            "fc1": _lin(a.fc1), "fc2": _lin(a.fc2)}
    return tree


def grads_to_jax(model: NeRFaceModel) -> Dict[str, Any]:
    """The model's ``.grad`` fields as the JAX parameter tree (zeros where
    a parameter has no gradient)."""
    return params_to_jax(
        model, lambda p: p.grad if p.grad is not None else torch.zeros_like(p))
