"""Weights from the JAX package's parameter tree.

``params_from_jax`` takes the tree ``init_model_params`` (nerface.py:110-124
of the JAX package) returns, or a checkpoint's, converted to numpy arrays,
and loads it into a ``NeRFaceModel``. Two layout changes:
  - a linear layer's ``w`` is (in, out); ``nn.Linear.weight`` is (out, in);
  - AudioNet's conv ``w`` is (k, cin, cout) for NWC data (fields.py:338-351);
    ``nn.Conv1d.weight`` is (cout, cin, k) for NCW data.
``params_to_jax`` goes back, for round-trip checks, and ``grads_to_jax``
maps the ``.grad`` fields onto the same tree, so that gradients compare
leaf by leaf. ``net_from_jax`` / ``net_to_jax`` do the same for the small
nets outside the model (``AudioAttNet``, ``MaskGeneratorMLP``,
``WarpEmbeddingMLP``), each against its JAX ``*_init`` tree. With a train state's per-frame ``latent_codes`` table given,
``params_from_jax`` and ``grads_to_jax`` take and give the JAX train
state's whole tree, {"model": ..., "latent_codes": (frames, 32)}.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.fields import AudioAttNet, MaskGeneratorMLP, WarpEmbeddingMLP
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


def params_from_jax(model: NeRFaceModel, tree: Dict[str, Any],
                    latent_codes: Optional[torch.Tensor] = None) -> NeRFaceModel:
    """Load the JAX parameter tree (numpy leaves) into ``model`` in place;
    with ``latent_codes``, ``tree`` is the train state's {"model",
    "latent_codes"} and the codes are loaded into that tensor too."""
    if latent_codes is not None:
        with torch.no_grad():
            latent_codes.copy_(_t(tree["latent_codes"]))
        tree = tree["model"]
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


def grads_to_jax(model: NeRFaceModel,
                 latent_codes: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """The model's ``.grad`` fields as the JAX parameter tree (zeros where
    a parameter has no gradient); with ``latent_codes``, the train state's
    {"model", "latent_codes"} tree."""
    grad = lambda p: p.grad if p.grad is not None else torch.zeros_like(p)
    tree = params_to_jax(model, grad)
    if latent_codes is None:
        return tree
    return {"model": tree,
            "latent_codes": grad(latent_codes).detach().cpu().numpy()}


def _load_convs(convs, ps) -> None:
    if len(convs) != len(ps):
        raise ValueError(f"conv count {len(ps)} != {len(convs)}")
    with torch.no_grad():
        for c, p in zip(convs, ps):
            c.weight.copy_(_t(p["w"]).permute(2, 1, 0))   # (k, cin, cout) -> (cout, cin, k)
            c.bias.copy_(_t(p["b"]))


_NERF_HEADS = ("fc_feat", "fc_alpha", "fc_rgb", "fc_seg")


def net_from_jax(net: nn.Module, tree: Dict[str, Any]) -> nn.Module:
    """Load a JAX tree (numpy leaves) into one of the small nets in place:
    ``audio_att_net_init``'s {"convs", "fc"}, ``mask_generator_init``'s
    NeRF-like tree, ``warp_embedding_init``'s {"layers"}."""
    if isinstance(net, AudioAttNet):
        _load_convs(net.convs, tree["convs"])
        _load_linear(net.fc, tree["fc"])
    elif isinstance(net, MaskGeneratorMLP):
        _load_linears(net.trunk.layers, tree["trunk"])
        for name in _NERF_HEADS:
            _load_linear(getattr(net, name), tree[name])
        _load_linears(net.dir, tree["dir"])
        _load_linears(net.seg, tree["seg"])
    elif isinstance(net, WarpEmbeddingMLP):
        _load_linears(net.layers, tree["layers"])
    else:
        raise TypeError(f"no JAX layout for {type(net).__name__}")
    return net


def net_to_jax(net: nn.Module) -> Dict[str, Any]:
    """The inverse of ``net_from_jax``: a tree of numpy arrays."""
    np_ = lambda p: p.detach().cpu().numpy()
    lin = lambda l: {"w": np_(l.weight).T, "b": np_(l.bias)}
    if isinstance(net, AudioAttNet):
        return {"convs": [{"w": np_(c.weight).transpose(2, 1, 0), "b": np_(c.bias)}
                          for c in net.convs], "fc": lin(net.fc)}
    if isinstance(net, MaskGeneratorMLP):
        return {"trunk": [lin(l) for l in net.trunk.layers],
                **{name: lin(getattr(net, name)) for name in _NERF_HEADS},
                "dir": [lin(l) for l in net.dir], "seg": [lin(l) for l in net.seg]}
    if isinstance(net, WarpEmbeddingMLP):
        return {"layers": [lin(l) for l in net.layers]}
    raise TypeError(f"no JAX layout for {type(net).__name__}")
