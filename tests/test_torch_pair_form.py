"""K2's pair= form (``level_train.nerf_level_train(..., pair=...)``: K2's
call, then K3's rays= call on K2's gx) and the tools around it, on the
CPU:

  (a) the port's CUDA sources reach the tensor cores through wgmma alone:
      no source issues a warp-level mma product, names the dW kernel of
      the old float32 gz stash or includes the headers that held them; the
      pair= form makes K2's call (launch 3 on bwd_tc_kernel, the backward
      tile on wgmma) and then K3's rays= call (the deformation nets'
      backward tile of skip_bw.cuh) on the gx that K2's call wrote, each
      with the arguments its C entry declares;
  (b) the pair= form's buffers in either dtype have the sizes their plans
      give: the level's and the pair's stashes, the tiles' column sums
      (bf16) and the dW's chunk partials and output, and the bf16 launches'
      stage blobs and work items;
  (c) ``train/trace_step.py --variant`` sets the fused step's flags as each
      variant asks and restores them afterwards, also when the traced code
      raises.
"""
import os
import re

import numpy as np
import pytest
import torch

from sahs_tpu_torch.config import Config
from sahs_tpu_torch.models import nerface
from sahs_tpu_torch.ops.grid import _cell_geometry, pack_corner_table
from sahs_tpu_torch.ops.kernels import _build
from sahs_tpu_torch.ops.kernels import deform_pair as k1
from sahs_tpu_torch.ops.kernels import level_train as k2
from sahs_tpu_torch.ops.kernels import nerf_level as k5
from sahs_tpu_torch.ops.kernels import skip_mlp
from sahs_tpu_torch.ops.kernels.field_mlp import (TP_BF16, dw_chunks, dw_items,
                                                   level_dw_chunks, tile_points)
from sahs_tpu_torch.train import fused
from sahs_tpu_torch.train import trace_step

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "sahs_tpu_torch", "csrc")
SOURCES = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _text(name):
    with open(os.path.join(CSRC, name)) as fp:
        return fp.read()


def _function(text, head):
    """The body of the C++ function whose definition starts with ``head``,
    up to its closing brace at the start of a line."""
    i = text.index(head)
    return text[i:text.index("\n}\n", i) + 2]


@pytest.mark.parametrize("name", SOURCES)
def test_no_source_takes_another_path_to_the_tensor_cores(name):
    """Every CUDA source of the port: no mma.sync product (nor the helper
    that issued it), no dW kernel over the float32 gz stash, no include of
    the headers that held them."""
    text = _text(name)
    for word in ("mma.sync", "mma16816", "stash_dw_kernel", "bwd_tc_fold_kernel"):
        assert word not in text, (name, word)
    for header in ("mma.cuh", "skip_tc.cuh"):
        assert f'#include "{header}"' not in text, (name, header)
    assert "mma.cuh" not in SOURCES and "skip_tc.cuh" not in SOURCES


def test_pair_form_runs_the_level_tiles_then_the_pair_tile(pair_calls):
    """The pair= form in either dtype is two C calls: K2's
    (sahs_level_train in the loss mode, bf16: launch 1 fwd_tc_kernel, the
    compositing, launch 3 bwd_tc_kernel, level_dw.cuh's dW), which writes gx
    to a scratch, then K3's rays= call (sahs_deform_pair_vjp_rays: bf16
    pair_bwd_wg_kernel, skip_bw.cuh's sb::tile, and level_dw.cuh's dW;
    float32 pair_vjp_kernel and dw_kernel) on the level's rays (ro, its
    directions, z) with that gx as the cotangent, no g2 and no points'
    cotangent. level_train.cu builds no pair kernel of its own."""
    for dtype, calls in pair_calls.items():
        assert [c[:2] for c in calls] == [("level_train", "sahs_level_train"),
                                          ("deform_pair_vjp", "sahs_deform_pair_vjp_rays")]
        (_, _, _, k2_args, (ro, z)), (_, _, _, k3_args, _) = calls
        assert k2_args[15] == k2._MODES["loss"]
        assert k2_args[9:13] == (None,) * 4              # no g_rgb, g_w, extra, gextra
        assert k2_args[47] == int(dtype == "bfloat16")   # the bf16 flag
        gx = k2_args[24]
        assert gx is not None and k3_args[5:8] == (gx, None, None)   # g, g2, gx
        # the rays: ro, the level's directions and z as K2 read them
        assert k3_args[:5] == (ro.data_ptr(), k2_args[3], k2_args[4], *z.shape)
        assert k2_args[4] == z.data_ptr()
    src = _text("level_train.cu")
    for word in ("pair_bwd_wg_kernel", "pair_vjp_kernel", "sahs_level_train_pair",
                 '#include "pair_bwd.cuh"', '#include "skip_bw.cuh"'):
        assert word not in src, word
    tc = _function(src, "int launch_tc(")
    assert tc.index("launch_fwd(fwd_tc_kernel, a, stream)") < tc.index("composite_kernel<<<") \
        < tc.index("launch_bwd(a, stream)") < tc.index("ldw::launch_level_dw(")
    assert "bwd_tc_kernel<<<" in _function(src, "int launch_bwd(")
    k3 = _text("deform_pair_vjp.cu")
    assert re.search(r"__launch_bounds__\(sb::THREADS, 1\)\npair_bwd_wg_kernel\("
                     r"const __grid_constant__ sb::Args a\) \{\n"
                     r"  extern __shared__ __align__\(1024\) unsigned char sb_smem\[\];\n"
                     r"  sb::tile\(a, sb_smem\);\n\}", k3)
    assert "sahs::pair_bwd_tile<T>(a, smem_raw, blockIdx.x);" in k3
    wg = _function(k3, "int launch_wg(")
    assert wg.index("sb::launch(pair_bwd_wg_kernel, a, stream)") < wg.index(
        "ldw::launch_level_dw(")


def _c_signature(text, name):
    """The ctypes letters of the C function ``name``'s parameters: p for a
    pointer, l for long long, i for int, f for float."""
    params = re.search(rf'extern "C" int {name}\((.*?)\) \{{', text, re.S).group(1)
    out = ""
    for param in (q.strip() for q in params.split(",")):
        kind = param.rsplit(" ", 1)[0]
        out += ("p" if "*" in param else "l" if kind == "long long" else
                "i" if kind == "int" else "f" if kind == "float" else "?")
    return out


@pytest.mark.parametrize("entry", ["sahs_level_train", "sahs_level_train_pair",
                                   "sahs_deform_pair_vjp", "sahs_deform_pair_vjp_rays"])
def test_c_entries_take_the_arguments_python_passes(entry, pair_calls):
    """Each C entry of the level's and the pair's backward takes, argument
    for argument, the ctypes types its Python wrapper declares (K2's
    _SIGNATURE, K3's _VJP_SIGNATURE after the points or the rays).
    "sahs_level_train_pair" stands for the pair= form, which has no C entry
    of its own: each of its two calls, in either dtype, passes as many
    arguments as the entry it calls declares, with those types."""
    files = {"sahs_level_train": "level_train.cu", "sahs_deform_pair_vjp": "deform_pair_vjp.cu",
             "sahs_deform_pair_vjp_rays": "deform_pair_vjp.cu"}
    want = {"sahs_level_train": k2._SIGNATURE,
            "sahs_deform_pair_vjp": "pl" + k1._VJP_SIGNATURE,
            "sahs_deform_pair_vjp_rays": "pppli" + k1._VJP_SIGNATURE}
    if entry != "sahs_level_train_pair":
        assert _c_signature(_text(files[entry]), entry) == want[entry]
        return
    assert not any("sahs_level_train_pair" in _text(name) for name in SOURCES)
    for calls in pair_calls.values():
        for _, symbol, types, args, _ in calls:
            assert types == want[symbol] == _c_signature(_text(files[symbol]), symbol)
            assert len(args) == len(types)


@pytest.fixture(scope="module")
def model():
    cfg = Config()
    spec = nerface.ModelSpec.from_config(cfg)
    return spec, nerface.NeRFaceModel.init(spec, seed=0, device="cpu")


@pytest.fixture(scope="module")
def weights(model):
    spec, model = model
    rng = np.random.RandomState(0)
    driving = torch.tensor(rng.randn(76).astype(np.float32))
    pose = torch.tensor(rng.randn(36).astype(np.float32))
    warp_g, pts_g, dir_g = nerface.build_pe_groups(spec)
    ncond = torch.cat([driving, pose]) if model.coarse.spec.include_driving else pose
    level = k5.prepare_level(model.coarse, ncond, pts_g, dir_g)
    pair = k1.prepare_pair(model.warp, model.hyper, torch.cat([driving, pose]), warp_g)
    return level, pair


@pytest.fixture(scope="module")
def pair_calls(model, weights):
    """{dtype: the C calls of one pair= call of K2 at 12 rays of 16 samples}:
    the wrapper's _launch runs on CPU tensors with the device check passed
    and each C function recorded, not run, as (library, symbol, ctypes
    letters, arguments, the rays ro and z)."""
    level, pair = weights
    rng = np.random.RandomState(1)
    R, S = 12, 16
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    pts = t(np.concatenate([rng.uniform(-1, 1, (R * S, 3)), rng.uniform(-1, 1, (R * S, 2))], 1))
    dirs = t(rng.randn(R, 3) * 0.1 + [0, 0, -1])
    z = t(np.sort(rng.uniform(0.5, 1.1, (R, S)), axis=-1))
    ro = t(rng.randn(R, 3) * 0.05 + [0, 0, 1.2])
    tgt = t(np.concatenate([rng.rand(R, 3), np.eye(12)[rng.randint(0, 12, R)]], 1))
    lw = t(np.stack([np.full(R, 1.0 / R), np.full(R, 0.02 / R)], 1))
    rows, _, _ = _cell_geometry(pts, (32, 32, 32))
    calls = []

    def function(lib, symbol, types):
        return lambda *args: calls.append((lib, symbol, types, args, (ro, z))) or 0

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "function", function)
        mp.setattr(_build, "stream_ptr", lambda dev: 0)
        mp.setattr(k2, "check_device", lambda *a: None)
        for dtype, dt in DTYPES.items():
            table = pack_corner_table(model[1].spatial_embeddings.detach(), dtype=dt)
            calls.clear()
            k2._launch("loss", "nerf_level_train", pts, dirs, table, rows, level, dtype,
                       (32, 32, 32), z=z, tgt=tgt, lw=lw, pair=(pair, ro))
            out[dtype] = list(calls)
    return out


@pytest.mark.parametrize("points", [64 * 130, 64 * 700 + 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pair_form_buffers_follow_their_plans(weights, dtype, points):
    """The buffers of one pair= call, built on the CPU as the wrapper builds
    them on the card: each stash a tile's block per tile of the dtype's
    tile size (bf16 stashes in bf16, 64 points; float32 in float32, 32), in
    bf16 the tiles' column sums (one float a gz row), the chunks' partials
    and the output of each dW (level_dw.cuh's chunks in bf16, train.cuh's
    in float32), and the bf16 launches' stage blobs (their bytes as passed)
    and work items (dw_items of the plan, four ints each)."""
    level, pair = weights
    dt = DTYPES[dtype]
    bf16 = dt == torch.bfloat16
    tp = tile_points(dt)
    assert tp == (TP_BF16 if bf16 else 32)
    n_tiles = -(-points // tp)
    plan = k2.level_train_plan(level, dt)
    pplan = k1.pair_train_plan(pair, dt)
    acts, gzs, bsum, chunks, part, out, bwd = k2._call_buffers(level, plan, n_tiles, dt,
                                                               torch.device("cpu"))
    nw, nh = len(pair.warp_trunk), len(pair.hyper_trunk)
    pacts, pgzs, pchunks, ppart, pout, pwg, held = skip_mlp.vjp_buffers(
        pair, pplan, [nw, nw + 1 + nh], [nw, nh], False, n_tiles, dt, torch.device("cpu"))
    n_chunks = level_dw_chunks(n_tiles) if bf16 else dw_chunks(n_tiles)
    for a, g, c, pa, o, pl in ((acts, gzs, chunks, part, out, plan),
                               (pacts, pgzs, pchunks, ppart, pout, pplan)):
        assert a.dtype == dt and a.numel() == n_tiles * pl.act_stride
        assert g.dtype == dt and g.numel() == n_tiles * pl.gz_stride
        assert pl.act_stride % tp == 0 and pl.gz_stride % tp == 0
        assert c == n_chunks
        assert pa.dtype == torch.float32 and pa.numel() == c * pl.out_len
        assert o.dtype == torch.float32 and o.numel() == pl.out_len
    if not bf16:
        assert bsum is None and bwd == (None, 0, None, None, 0) and held == ()
        assert pwg[0] is None and pwg[1] == 0
        return
    # the level's launch 3: its stages, bsum, the dW's items
    stages = k2.backward_stages(level, plan)
    assert bwd[1] == 2 * stages.numel() and bwd[4] == len(dw_items(plan.descs))
    assert bsum.dtype == torch.float32 and bsum.numel() == n_tiles * plan.gz_stride // tp
    # the pair's: its two stage blobs, its host tables, bsum, the items
    wf, wb, items, pbsum = held[:4]
    assert (pwg[1], pwg[3]) == (2 * wf.numel(), 2 * wb.numel())
    assert pwg[6] == len(pplan.descs_t) and pwg[10] == len(dw_items(pplan.descs))
    assert items.numel() == 4 * pwg[10]
    assert pbsum.dtype == torch.float32 and pbsum.numel() == n_tiles * pplan.gz_stride // tp
    assert len(pplan.descs_t) == len(pair.warp_trunk) + len(pair.hyper_trunk)


@pytest.mark.parametrize("name", sorted(trace_step.VARIANTS))
def test_trace_variant_sets_and_restores_the_flags(monkeypatch, name):
    """Inside ``trace_step.variant(name)`` exactly the variant's flags of
    train/fused.py are on, and ``current_variant`` names it; after it,
    each flag is what it was, after a normal exit and after an
    exception."""
    before = {"_BWD_SPLIT": True, "_UNION": False, "_PAIR_RAYS": True, "_PAIR_FOLD": False}
    for f, v in before.items():
        monkeypatch.setattr(fused, f, v)
    assert set(trace_step.FLAGS) == set(before)
    assert trace_step.current_variant() == "_BWD_SPLIT+_PAIR_RAYS"   # no variant's flags
    with trace_step.variant(name):
        assert {f: getattr(fused, f) for f in before} == {
            f: f in trace_step.VARIANTS[name] for f in before}
        assert trace_step.current_variant() == name
    assert {f: getattr(fused, f) for f in before} == before
    with pytest.raises(RuntimeError):
        with trace_step.variant(name):
            raise RuntimeError("inside")
    assert {f: getattr(fused, f) for f in before} == before
    want = {"default": set(), "split": {"_BWD_SPLIT"}, "union": {"_UNION"},
            "rays": {"_PAIR_RAYS"}, "fold": {"_PAIR_FOLD"},
            "rays_fold": {"_PAIR_RAYS", "_PAIR_FOLD"}, "rays_union": {"_PAIR_RAYS", "_UNION"}}
    assert set(trace_step.VARIANTS[name]) == want[name]
