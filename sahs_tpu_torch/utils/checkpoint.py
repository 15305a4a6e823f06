"""Checkpoints of the port: the JAX package's native format, and its
one-way importer of reference PyTorch checkpoints (the Stage-I part of
``sahs_tpu/utils/checkpoint.py``, copied: the port never imports the JAX
package).

Native format, version 2: a ``.npz`` archive of flattened tree leaves, no
pickle anywhere (loading an untrusted file cannot run code):
  __schema__            JSON header {format, version, scalars, bf16 keys}
  params|<tree path>    a leaf of the JAX train state's parameter tree
                        {"model", "background"?, "latent_codes"?}, named and
                        laid out as ``utils/weights.params_to_jax`` gives it
                        (a linear layer's w as (in, out))
  opt|0/count, opt|1/count, opt|0/mu|<path>, opt|0/nu|<path>
                        the optimizer state as optax's ``adam`` flattens it:
                        torch Adam's step, exp_avg and exp_avg_sq (the same
                        update: eps outside the square root in both)
  sample_prob, background, pose_c, ...   top-level arrays
  iter, height, width   scalars in the header
The same names and layouts as the JAX package, so a checkpoint written by
either package resumes in the other. bf16 leaves are stored as their
uint16 bits (a view through torch). A checkpoint whose structure does not
match the model and optimizer (another model, or one written by the JAX
package under ``SAHS_OPT_FLATTEN=1``) raises CheckpointError.

The importer maps a released reference ``.ckpt`` (torch.save) onto the
parameter tree; ``weights.params_from_jax`` loads the tree into a model.

Stage II: ``stage2_sections`` gives the sections the JAX package's
Stage-II CLI writes with ``save_sections`` (params, bufs and optax adam's
state of the generator; d_params, d_bufs, d_opt with the discriminator),
in its leaf names and layouts (``models/spade.to_jax``), and
``restore_stage2_state`` resumes a trainer state from either package's;
``import_torch_generator_checkpoint`` maps a reference Generator
checkpoint onto the JAX package's (params, bufs) trees, which
``models/spade.from_jax`` loads.
"""
from __future__ import annotations

import copy
import json
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from .weights import params_from_jax, params_to_jax

CKPT_FORMAT = "sahs-ckpt"
CKPT_VERSION = 2
_SCHEMA_KEY = "__schema__"


class CheckpointError(RuntimeError):
    pass


def _to_numpy(v, key: str, bf16_keys: list) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            bf16_keys.append(key)
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    return np.asarray(v)


def _flatten_section(prefix: str, tree, out: Dict[str, np.ndarray],
                     bf16_keys: list, path=()) -> None:
    """Leaves of a tree of dicts and lists under ``prefix|a/0/b`` (dict
    keys and list indices joined by '/', as JAX's tree paths)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_section(prefix, tree[k], out, bf16_keys, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_section(prefix, v, out, bf16_keys, path + (str(i),))
    elif tree is not None:
        key = f"{prefix}|{'/'.join(path)}" if path else prefix
        out[key] = _to_numpy(tree, key, bf16_keys)


def _write(path: str, entries: Dict[str, np.ndarray], scalars: Dict[str, Any],
           bf16: list) -> None:
    """Atomic write (tmp + rename)."""
    schema = {"format": CKPT_FORMAT, "version": CKPT_VERSION,
              "scalars": scalars, "bf16_keys": bf16}
    entries[_SCHEMA_KEY] = np.frombuffer(json.dumps(schema).encode(), dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as fp:
        np.savez(fp, **entries)
    os.replace(tmp, path)


def _state_tree(state, get=lambda p: p) -> Dict[str, Any]:
    """The JAX train state's parameter tree of ``state`` (numpy leaves),
    each parameter mapped through ``get`` first."""
    tree: Dict[str, Any] = {"model": params_to_jax(state.model, get)}
    for name in ("background", "latent_codes"):
        p = getattr(state, name)
        if p is not None:
            tree[name] = get(p).detach().cpu().numpy()
    return tree


def _adam_tree(opt, tree) -> list:
    """optax adam's state of the torch Adam ``opt``, its moments laid out
    by ``tree(get)`` (the JAX parameter tree, each parameter mapped through
    ``get``): the moments of a parameter Adam has not updated yet are
    zeros."""
    st = opt.state

    def moment(name):
        return lambda p: st[p][name] if name in st.get(p, {}) else torch.zeros_like(p)
    steps = [float(s["step"]) for s in st.values() if "step" in s]
    count = np.int32(max(steps) if steps else 0)
    return [{"count": count, "mu": tree(moment("exp_avg")),
             "nu": tree(moment("exp_avg_sq"))}, {"count": count}]


def save_checkpoint(path: str, state, extras: Optional[Dict[str, Any]] = None):
    """``state``: the port's TrainState (train/stage1.py). ``extras``: e.g.
    background, pose_c, height, width, focal_length; a number goes into
    the header, an array into its own entry."""
    entries: Dict[str, np.ndarray] = {}
    bf16: list = []
    _flatten_section("params", _state_tree(state), entries, bf16)
    _flatten_section("opt", _adam_tree(state.optimizer,
                                       lambda get: _state_tree(state, get)), entries, bf16)
    entries["sample_prob"] = _to_numpy(state.sample_prob, "sample_prob", bf16)
    scalars: Dict[str, Any] = {"iter": int(state.step)}
    for k, v in (extras or {}).items():
        if v is None:
            continue
        arr = _to_numpy(v, k, bf16)
        if arr.ndim == 0 and arr.dtype.kind in "ifb":
            scalars[k] = arr.item()
        else:
            entries[k] = arr
    _write(path, entries, scalars, bf16)


def is_native_checkpoint(path: str) -> bool:
    """True iff ``path`` is a version-2 native checkpoint (a zip archive
    with the schema entry): tells ours from torch.save zips without
    deserialising anything."""
    try:
        with zipfile.ZipFile(path) as zf:
            return _SCHEMA_KEY + ".npy" in zf.namelist()
    except (zipfile.BadZipFile, OSError):
        return False


def load_checkpoint(path: str):
    """-> (flat entries {key: CPU tensor}, schema dict); bf16 entries come
    back as bfloat16 tensors. Raises CheckpointError on a format problem
    (never misparses silently; no pickle is ever run)."""
    try:
        npz = np.load(path, allow_pickle=False)
    except Exception as e:   # any reason the archive cannot be opened
        raise CheckpointError(f"{path}: not a native checkpoint archive ({e})") from e
    if _SCHEMA_KEY not in npz.files:
        raise CheckpointError(f"{path}: missing {_SCHEMA_KEY} — not a {CKPT_FORMAT} file")
    schema = json.loads(bytes(npz[_SCHEMA_KEY]).decode())
    if schema.get("format") != CKPT_FORMAT:
        raise CheckpointError(f"{path}: format {schema.get('format')!r}, "
                              f"expected {CKPT_FORMAT!r}")
    if schema.get("version", 0) > CKPT_VERSION:
        raise CheckpointError(
            f"{path}: checkpoint version {schema['version']} is newer than "
            f"this build supports ({CKPT_VERSION})")
    bf16 = set(schema.get("bf16_keys", ()))
    entries = {}
    for k in npz.files:
        if k == _SCHEMA_KEY:
            continue
        arr = npz[k]
        if k in bf16:
            entries[k] = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            entries[k] = torch.from_numpy(arr)
    return entries, schema


def _restore_section(prefix: str, template, entries, path: str, shapes: bool,
                     keys=()):
    """The template tree's structure with its leaves from ``entries``; a
    missing entry (or, with ``shapes``, one of another shape) raises."""
    if isinstance(template, dict):
        return {k: _restore_section(prefix, v, entries, path, shapes, keys + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_restore_section(prefix, v, entries, path, shapes, keys + (str(i),))
                for i, v in enumerate(template)]
    key = f"{prefix}|{'/'.join(keys)}" if keys else prefix
    if key not in entries:
        raise CheckpointError(
            f"{path}: missing entry {key!r} — checkpoint does not match the "
            f"current model/optimizer structure")
    if shapes and tuple(entries[key].shape) != tuple(np.shape(template)):
        raise CheckpointError(
            f"{path}: entry {key!r} has shape {tuple(entries[key].shape)}, the "
            f"current model/optimizer {tuple(np.shape(template))}")
    return entries[key]


def unflatten_params(entries: Dict[str, Any], prefix: str = "params") -> Dict[str, Any]:
    """The nested dict/list tree from flat path keys (integer components
    become list indices)."""
    root: Dict[str, Any] = {}
    pre = prefix + "|"
    for key in sorted(k for k in entries if k.startswith(pre)):
        parts = key[len(pre):].split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = entries[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_sections(path: str, sections: Dict[str, Any],
                  scalars: Optional[Dict[str, Any]] = None):
    """A generic native checkpoint: each named section, a tree of dicts,
    lists and arrays or tensors, flattened under ``<name>|<path>``; the
    scalars go into the header."""
    entries: Dict[str, np.ndarray] = {}
    bf16: list = []
    for name, tree in sections.items():
        _flatten_section(name, tree, entries, bf16)
    _write(path, entries, dict(scalars or {}), bf16)


def restore_sections(path: str, templates: Optional[Dict[str, Any]] = None):
    """-> (sections dict, scalars dict), leaves as CPU tensors. A section
    named in ``templates`` is restored into that tree's structure (every
    leaf of the template must be there); the others are rebuilt from their
    path keys as nested dict/list trees."""
    entries, schema = load_checkpoint(path)
    names = {k.split("|", 1)[0] for k in entries if "|" in k}
    out: Dict[str, Any] = {}
    for name in names:
        if templates and name in templates:
            out[name] = _restore_section(name, templates[name], entries, path, False)
        else:
            out[name] = unflatten_params(entries, prefix=name)
    for k, v in entries.items():
        if "|" not in k:
            out[k] = v
    return out, schema.get("scalars", {})


def _param_map(state, tree) -> Dict[torch.nn.Parameter, torch.Tensor]:
    """Each trained parameter of ``state`` -> its value in ``tree`` (the
    JAX layout), in the parameter's own layout and on its device."""
    scratch = copy.deepcopy(state.model)
    params_from_jax(scratch, tree["model"])
    out = {p: s.detach() for p, s in zip(state.model.parameters(), scratch.parameters())}
    for name in ("background", "latent_codes"):
        p = getattr(state, name)
        if p is not None:
            out[p] = tree[name].to(device=p.device, dtype=p.dtype)
    return out


def restore_train_state(path: str, state):
    """Resume ``state`` (a freshly initialised TrainState of the same
    configuration, which gives the structure) from a native checkpoint in
    place: the parameters, Adam's moments and count, the step (so the
    learning-rate schedule goes on from it) and sample_prob. Returns
    (state, extras): the checkpoint's other arrays and scalars."""
    entries, schema = load_checkpoint(path)
    template = _state_tree(state)
    params = _restore_section("params", template, entries, path, True)
    opt = _restore_section("opt", [{"count": 0, "mu": template, "nu": template},
                                   {"count": 0}], entries, path, True)
    values, mu, nu = (_param_map(state, t) for t in (params, opt[0]["mu"], opt[0]["nu"]))
    count = float(opt[0]["count"])
    with torch.no_grad():
        for p, v in values.items():
            p.copy_(v)
            # a parameter whose moments are zero has had no gradient yet:
            # torch's Adam keeps no state for it and counts its own steps
            # from its first update, so it gets none
            state.optimizer.state.pop(p, None)
            if bool(mu[p].any()) or bool(nu[p].any()):
                state.optimizer.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": mu[p].clone(), "exp_avg_sq": nu[p].clone()}
    dev = state.sample_prob.device
    state.step = int(schema["scalars"]["iter"])
    state.sample_prob = entries["sample_prob"].to(device=dev, dtype=torch.float32)
    extras = {k: v for k, v in entries.items() if "|" not in k and k != "sample_prob"}
    extras.update({k: v for k, v in schema["scalars"].items() if k != "iter"})
    return state, extras


# ---------------------------------------------------------------------------
# Reference PyTorch state dicts <-> the parameter tree
# ---------------------------------------------------------------------------

def _lin(sd, prefix):
    return {"w": np.asarray(sd[prefix + ".weight"]).T.copy(),
            "b": np.asarray(sd[prefix + ".bias"]).copy()}


def _trunk(sd, prefix, n_layers):
    return [_lin(sd, f"{prefix}.{i}") for i in range(n_layers)]


def _nerf_mlp(sd, prefix, n_layers):
    return {"trunk": _trunk(sd, prefix + ".layers_xyz", n_layers),
            "fc_feat": _lin(sd, prefix + ".fc_feat"),
            "fc_alpha": _lin(sd, prefix + ".fc_alpha"),
            "dir": _trunk(sd, prefix + ".layers_dir", 4),
            "fc_rgb": _lin(sd, prefix + ".fc_rgb"),
            "seg": _trunk(sd, prefix + ".layers_seg", 4),
            "fc_seg": _lin(sd, prefix + ".fc_seg")}


def _conv1d(sd, prefix):
    # torch Conv1d weight (out, in, k) -> the tree's (k, in, out)
    return {"w": np.asarray(sd[prefix + ".weight"]).transpose(2, 1, 0).copy(),
            "b": np.asarray(sd[prefix + ".bias"]).copy()}


def import_torch_state_dict(sd: Dict[str, Any], spec) -> Dict[str, Any]:
    """A reference model_state_dict (tensors or numpy arrays) -> the model's
    parameter tree (numpy), for ``weights.params_from_jax``. Key layout of
    the reference module tree (models.py:189-528, modules.py:43-462)."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in sd.items()}
    params: Dict[str, Any] = {}
    if spec.use_warp:
        params["warp"] = {
            "trunk": _trunk(sd, "warp_field_mlp.layers_xyz", spec.warp.num_layers),
            "out": _lin(sd, "warp_field_mlp.fc_final")}
    if spec.use_ambient:
        params["hyper"] = {
            "trunk": _trunk(sd, "hyper_sheep_mlp.layers_ambient", spec.hyper.num_layers),
            "out": _lin(sd, "hyper_sheep_mlp.fc_ambient")}
    params["coarse"] = _nerf_mlp(sd, "nerf_mlps.coarse", spec.coarse.num_layers)
    if spec.fine is not None:
        params["fine"] = _nerf_mlp(sd, "nerf_mlps.fine", spec.fine.num_layers)
    if spec.use_spatial_embeddings:
        # torch (1, C, D, H, W) -> (C, D, H, W)
        params["spatial_embeddings"] = np.asarray(sd["spatial_embeddings"])[0]
    if spec.is_audio:
        params["audnet"] = {
            "convs": [_conv1d(sd, f"audNet_head.encoder_conv.{i}") for i in (0, 2, 4, 6)],
            "fc1": _lin(sd, "audNet_head.encoder_fc1.0"),
            "fc2": _lin(sd, "audNet_head.encoder_fc1.2")}
    return params


def export_torch_state_dict(params: Dict[str, Any], spec) -> Dict[str, np.ndarray]:
    """The inverse of ``import_torch_state_dict``: the parameter tree onto
    the reference module names (numpy arrays, torch layout)."""
    sd: Dict[str, np.ndarray] = {}

    def lin(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["w"]).T.copy()
        sd[prefix + ".bias"] = np.asarray(p["b"]).copy()

    def trunk(prefix, layers):
        for i, p in enumerate(layers):
            lin(f"{prefix}.{i}", p)

    def nerf_mlp(prefix, p):
        trunk(prefix + ".layers_xyz", p["trunk"])
        lin(prefix + ".fc_feat", p["fc_feat"])
        lin(prefix + ".fc_alpha", p["fc_alpha"])
        trunk(prefix + ".layers_dir", p["dir"])
        lin(prefix + ".fc_rgb", p["fc_rgb"])
        trunk(prefix + ".layers_seg", p["seg"])
        lin(prefix + ".fc_seg", p["fc_seg"])

    if spec.use_warp:
        trunk("warp_field_mlp.layers_xyz", params["warp"]["trunk"])
        lin("warp_field_mlp.fc_final", params["warp"]["out"])
    if spec.use_ambient:
        trunk("hyper_sheep_mlp.layers_ambient", params["hyper"]["trunk"])
        lin("hyper_sheep_mlp.fc_ambient", params["hyper"]["out"])
    nerf_mlp("nerf_mlps.coarse", params["coarse"])
    if spec.fine is not None and "fine" in params:
        nerf_mlp("nerf_mlps.fine", params["fine"])
    if spec.use_spatial_embeddings:
        sd["spatial_embeddings"] = np.asarray(params["spatial_embeddings"])[None].copy()
    if spec.is_audio:
        a = params["audnet"]
        for slot, cp in zip((0, 2, 4, 6), a["convs"]):
            # the tree's (k, in, out) -> torch Conv1d (out, in, k)
            sd[f"audNet_head.encoder_conv.{slot}.weight"] = \
                np.asarray(cp["w"]).transpose(2, 1, 0).copy()
            sd[f"audNet_head.encoder_conv.{slot}.bias"] = np.asarray(cp["b"]).copy()
        lin("audNet_head.encoder_fc1.0", a["fc1"])
        lin("audNet_head.encoder_fc1.2", a["fc2"])
    return sd


def import_torch_checkpoint(path: str, spec) -> Dict[str, Any]:
    """Load a reference torch checkpoint file (torch.save dict with
    model_state_dict) and return {"model": the parameter tree, "iter",
    and, where present, background, latent_codes, sample_prob, pose_c
    (CPU tensors) and height, width, focal_length}."""
    ckpt = torch.load(path, map_location="cpu")
    out: Dict[str, Any] = {"model": import_torch_state_dict(ckpt["model_state_dict"], spec),
                           "iter": ckpt.get("iter")}
    for k in ("background", "latent_codes", "sample_prob", "pose_c"):
        v = ckpt.get(k)
        if v is not None:
            out[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v
                                     ).detach().cpu()
    for k in ("height", "width", "focal_length"):
        if k in ckpt:
            out[k] = ckpt[k]
    return out


# ---------------------------------------------------------------------------
# Stage II: the reference's Generator checkpoints, and the trainer's state
# ---------------------------------------------------------------------------

def _conv2d_t(sd, prefix):
    """torch Conv2d (O, I, kh, kw) -> the JAX tree's HWIO."""
    return {"w": np.asarray(sd[prefix + ".weight"]).transpose(2, 3, 1, 0).copy(),
            "b": np.asarray(sd[prefix + ".bias"]).copy()}


def _bn_t(sd, prefix):
    p = {"gamma": np.asarray(sd[prefix + ".weight"]).copy(),
         "beta": np.asarray(sd[prefix + ".bias"]).copy()}
    b = {"mean": np.asarray(sd[prefix + ".running_mean"]).copy(),
         "var": np.asarray(sd[prefix + ".running_var"]).copy()}
    return p, b


def _sn_conv_t(sd, prefix):
    """A spectral-normalised conv: torch stores weight_orig, weight_u and
    weight_v. Both vectors are imported, so that eval reproduces torch's
    sigma exactly (sigma = u . (W v) with the stored vectors)."""
    w_orig = np.asarray(sd[prefix + ".weight_orig"])   # (O, I, kh, kw)
    O, I, kh, kw = w_orig.shape
    p = {"w": w_orig.transpose(2, 3, 1, 0).copy(),
         "b": np.asarray(sd[prefix + ".bias"]).copy()}
    # torch flattens the fan-in axis as (I, kh, kw); the JAX tree as (kh, kw, I)
    v = np.asarray(sd[prefix + ".weight_v"]).reshape(I, kh, kw)
    b = {"u": np.asarray(sd[prefix + ".weight_u"]).copy(),
         "v": v.transpose(1, 2, 0).reshape(-1).copy()}
    return p, b


def _resblock_t(sd, prefix, downsample):
    p = {"initial": _conv2d_t(sd, prefix + ".initial.0")}
    p["bn1"], bn1 = _bn_t(sd, prefix + ".initial.1")
    bufs = {"bn1": bn1}
    if downsample:
        p["down_id"] = _conv2d_t(sd, prefix + ".downsample_layer")
        p["down_res"] = _conv2d_t(sd, prefix + ".residual_downsample")
    else:
        p["residual"] = _conv2d_t(sd, prefix + ".residual.0")
        p["bn2"], bn2 = _bn_t(sd, prefix + ".residual.1")
        bufs["bn2"] = bn2
    return p, bufs


def _spade_layer_t(sd, prefix):
    return {"shared": _conv2d_t(sd, prefix + ".mlp_shared.0"),
            "gamma": _conv2d_t(sd, prefix + ".conv_gamma"),
            "beta": _conv2d_t(sd, prefix + ".conv_beta")}


def _spade_block_t(sd, prefix, downsample, upsample):
    p = {"spade1": _spade_layer_t(sd, prefix + ".spade1"),
         "spade2": _spade_layer_t(sd, prefix + ".spade2"),
         "spade_s": _spade_layer_t(sd, prefix + ".spade_s")}
    bufs = {}
    p["conv1"], bufs["conv1"] = _sn_conv_t(sd, prefix + ".conv1")
    p["conv2"], bufs["conv2"] = _sn_conv_t(sd, prefix + ".conv2")
    p["conv_s"], bufs["conv_s"] = _sn_conv_t(sd, prefix + ".conv_s")
    if downsample:
        p["down_id"] = _conv2d_t(sd, prefix + ".residual_downsample")
    if upsample:
        # a ConvTranspose2d's (I, O, kh, kw) through the same transpose is
        # (kh, kw, O, I), the kernel of lax.conv_transpose(...,
        # transpose_kernel=True); up_id is square, so a swap would not raise
        p["up_id"] = _conv2d_t(sd, prefix + ".residual_upsample")
    return p, bufs


def import_torch_generator_state_dict(sd: Dict[str, Any], audio: bool):
    """A reference Stage-II Generator(_audio) state_dict (tensors or numpy
    arrays) -> the JAX package's (params, bufs) trees, numpy leaves, for
    ``models.spade.from_jax`` (reference nerf-pytorch/nerf/_init_spade.py:
    IdEncoder :185-203, RefineNetwork :284-312, Generator :315-325,
    Generator_audio :359-373)."""
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
          for k, v in sd.items()}
    params: Dict[str, Any] = {}
    bufs: Dict[str, Any] = {}

    idp: Dict[str, Any] = {"stem": _conv2d_t(sd, "idencoder.layer1.0")}
    idb: Dict[str, Any] = {}
    for name, layer, down in (("l2", "layer2", False),
                              ("l3", "layer3", True),
                              ("l4", "layer4", True)):
        idp[name], idb[name] = _resblock_t(sd, f"idencoder.{layer}", down)
    params["idenc"], bufs["idenc"] = idp, idb

    # RefineNetwork layer2..7 <-> blocks[0..5]; (down, up) as REFINE_LAYERS
    flags = [(True, False), (True, False), (False, False),
             (False, True), (False, True), (False, True)]
    rp: Dict[str, Any] = {"stem": _conv2d_t(sd, "refine_network.layer1.0"),
                          "blocks": []}
    rb: Dict[str, Any] = {"blocks": []}
    for i, (down, up) in enumerate(flags):
        bp, bb = _spade_block_t(sd, f"refine_network.layer{i + 2}", down, up)
        rp["blocks"].append(bp)
        rb["blocks"].append(bb)
    rp["head"] = _conv2d_t(sd, "refine_network.layer8")
    params["refine"], bufs["refine"] = rp, rb

    if audio:
        params["audnet"] = {
            "convs": [_conv1d(sd, f"AudioNet.encoder_conv.{i}") for i in (0, 2, 4, 6)],
            "fc1": _lin(sd, "AudioNet.encoder_fc1.0"),
            "fc2": _lin(sd, "AudioNet.encoder_fc1.2"),
        }
    return params, bufs


def import_torch_generator_checkpoint(path: str, audio: bool) -> Dict[str, Any]:
    """A reference Stage-II ``.ckpt`` (torch.save dict with
    model_state_dict, reference train_get_texture_photo_audio.py:235-253)
    -> {"params", "bufs", "iter"}."""
    ckpt = torch.load(path, map_location="cpu")
    params, bufs = import_torch_generator_state_dict(ckpt["model_state_dict"], audio)
    return {"params": params, "bufs": bufs, "iter": ckpt.get("iter")}


def _stage2_adam_tree(opt, module) -> list:
    from ..models.spade import to_jax
    return _adam_tree(opt, lambda get: to_jax(module, "params", get))


def stage2_sections(state) -> Dict[str, Any]:
    """The Stage-II trainer's checkpoint sections, as the JAX package's CLI
    writes them: params, bufs and Adam's state of the generator, and of
    the discriminator (d_params, d_bufs, d_opt) when it has one."""
    from ..models.spade import to_jax
    g = state.generator
    sections = {"params": to_jax(g), "bufs": to_jax(g, "bufs"),
                "opt": _stage2_adam_tree(state.opt, g)}
    if state.discriminator is not None:
        d = state.discriminator
        sections.update(d_params=to_jax(d), d_bufs=to_jax(d, "bufs"),
                        d_opt=_stage2_adam_tree(state.d_opt, d))
    return sections


def _restore_stage2_adam(opt, module, tree) -> None:
    """optax's count and moments into the torch Adam ``opt``. Every
    parameter gets them: the Stage-II step hands Adam a zero gradient
    where a parameter had none, as optax updates every leaf."""
    from ..models.spade import param_map
    mu, nu = param_map(module, tree[0]["mu"]), param_map(module, tree[0]["nu"])
    count = float(tree[0]["count"])
    opt.state.clear()
    if count:
        for p in opt.param_groups[0]["params"]:
            opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                            "exp_avg": mu[p].clone(), "exp_avg_sq": nu[p].clone()}


def restore_stage2_state(path: str, state):
    """Resume a Stage-II state (a fresh one of the same settings) from a
    checkpoint of either package's trainer, in place: the generator's
    params and bufs, Adam's moments and count, the step, and the
    discriminator's when both have one. Returns (state, scalars)."""
    from ..models.spade import from_jax
    sections, scalars = restore_sections(path)
    from_jax(state.generator, sections["params"], sections["bufs"])
    _restore_stage2_adam(state.opt, state.generator, sections["opt"])
    if state.discriminator is not None and "d_params" in sections:
        from_jax(state.discriminator, sections["d_params"], sections["d_bufs"])
        _restore_stage2_adam(state.d_opt, state.discriminator, sections["d_opt"])
    state.step = int(scalars.get("step", 0))
    return state, scalars
