"""Readings behind two verdicts of ROADMAP Queue 3, on the CPU;
this script imports both packages, as the tests do:

    python tests/torch_queue3_readings.py eval    # item 1
    python tests/torch_queue3_readings.py grads   # item 2

eval: tests/test_torch_eval.py's tiny config (8 x 8 frames, 4 + 4
samples, the plain path, deterministic) with the weights scaled by 1.5, 2
and 3: each package's float32 render against the port's plain modules in
float64 on the same weights (max abs over rgb_coarse, rgb_fine, disp_fine
and depth_fine, per frame, with and without a latent code).

grads: tests/test_torch_train.py's tiny setup (48 rays, 8 + 8 samples,
float32, the live-sigma weights) on six (frame, key) draws, the first its
own: the worst three gradient leaves, each against its own norm, of JAX's
fused step (Pallas in interpret mode, its bf16 PE angle split, and with
the exact-f32 angle), JAX's plain path, the port's fused step (the
kernels' plain versions) and the port's plain path, each against the
port's plain path in float64 on the same weights and JAX's draws.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: F401,E402  (JAX on a true CPU backend)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from sahs_tpu_torch.config import Config as TConfig  # noqa: E402
from sahs_tpu_torch.models import nerface as tn  # noqa: E402
from sahs_tpu_torch.utils.weights import grads_to_jax, params_from_jax  # noqa: E402


def eval_readings():
    from sahs_tpu import evaluation as jev
    from sahs_tpu.config import Config as JConfig
    from sahs_tpu.models.nerface import ModelSpec as JSpec, init_model_params
    from sahs_tpu.render.pipeline import RenderSettings as JRS
    from sahs_tpu_torch.render.pipeline import RenderSettings, render_image
    from test_torch_eval import _FakeDataset, _tiny

    def t(x, dt):
        return None if x is None else torch.as_tensor(np.asarray(x)).to(dt)

    for scale in (1.5, 2.0, 3.0):
        for latent in (False, True):
            jcfg, tcfg = _tiny(JConfig, latent), _tiny(TConfig, latent)
            jspec, tspec = JSpec.from_config(jcfg), tn.ModelSpec.from_config(tcfg)
            params = jax.tree.map(lambda x: x * scale,
                                  init_model_params(jax.random.PRNGKey(0), jspec))
            tree = jax.tree.map(np.asarray, params)
            m32 = params_from_jax(tn.NeRFaceModel.init(tspec, device="cpu"), tree)
            m64 = params_from_jax(tn.NeRFaceModel.init(tspec, device="cpu"), tree).double()
            lat = (np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 32)))[0]
                   if latent else None)
            s = dataclasses.replace(RenderSettings.from_config(tcfg, "validation"),
                                    perturb=False, radiance_field_noise_std=0.0)
            js = JRS(num_coarse=s.num_coarse, num_fine=s.num_fine, perturb=False,
                     lindisp=s.lindisp, radiance_field_noise_std=0.0,
                     white_background=s.white_background, chunksize=s.chunksize)
            near, far = float(tcfg.dataset.near), float(tcfg.dataset.far)
            jr = jev.make_eval_renderer(jspec, js, 8, 8, near, far, with_latent=latent)
            ds = _FakeDataset()
            for i in range(2):
                it = ds[i]
                outs = {}
                for name, m, dt in (("f32", m32, torch.float32), ("f64", m64, torch.float64)):
                    with torch.no_grad():
                        outs[name] = render_image(
                            m, s, 8, 8, t(it["intrinsics"], dt), t(it["pose"], dt), near,
                            far, t(it["driving"], dt), latent_code=t(lat, dt))
                oj = jr(params, it["intrinsics"], it["pose"], it["driving"], None,
                        jax.random.PRNGKey(0), *((lat,) if latent else ()))
                line = []
                for k in ("rgb_coarse", "rgb_fine", "disp_fine", "depth_fine"):
                    ref = outs["f64"][k].numpy()
                    ep = np.abs(outs["f32"][k].double().numpy() - ref).max()
                    ej = np.abs(np.asarray(oj[k], np.float64) - ref).max()
                    line.append(f"{k} port {ep:.2e} jax {ej:.2e}")
                print(f"scale {scale} latent {latent} frame {i}: " + " | ".join(line),
                      flush=True)


def grads_readings():
    from sahs_tpu.data.synthetic import SyntheticFaceDataset
    from sahs_tpu.models import nerface as jn
    from sahs_tpu.ops.pallas import field_mlp as jfm
    from sahs_tpu.train import stage1 as jstage1
    from sahs_tpu_torch.train import stage1 as tstage1
    from test_torch_train import _jax_draws, _tree_pairs, tiny_cfg

    def jax_grads(cfg, pm, item, key):
        spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
        keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                            lambda g, s, p=None: (g, g))
        opt = optax.chain(keep, optax.sgd(1.0))
        st = jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts)
        st = st._replace(params={"model": pm}, opt_state=opt.init({"model": pm}))
        batch = {k: jnp.asarray(v) for k, v in item.items() if k != "fname"}
        st2, _ = jax.jit(lambda s, b, k: jstage1.train_step(s, b, k, spec, ts, opt))(
            st, batch, key)
        return jax.tree.map(np.asarray, st2.opt_state[0]["model"])

    def port_grads(use_pallas, pm, item, key, dtype):
        c = tiny_cfg(TConfig, use_pallas=use_pallas)
        spec, ts = tn.ModelSpec.from_config(c), tstage1.TrainSettings.from_config(c)
        st = tstage1.init_train_state(spec, ts, seed=0, device="cpu")
        params_from_jax(st.model, jax.tree.map(np.asarray, pm))
        st.model.to(dtype)
        st.optimizer = torch.optim.SGD(st.model.parameters(), lr=0.0)
        st.lr_fn = None
        _, draws = _jax_draws(key, 32, 32, 48, 8, 8)
        if dtype == torch.float64:
            draws = type(draws)(*(d if i == 0 else d.double() for i, d in enumerate(draws)))
        b = {k: (torch.as_tensor(np.asarray(v)).to(dtype)
                 if k in ("image", "pose", "intrinsics", "driving", "background") else v)
             for k, v in item.items() if k != "fname"}
        tstage1.train_step(st, b, spec, ts, draws=draws)
        return grads_to_jax(st.model)

    def rel(a, b):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)

    cfg = tiny_cfg()
    spec, ts = jn.ModelSpec.from_config(cfg), jstage1.TrainSettings.from_config(cfg)
    pm = dict(jstage1.init_train_state(jax.random.PRNGKey(0), spec, ts).params["model"])
    for lvl in ("coarse", "fine"):
        pm[lvl] = dict(pm[lvl], fc_alpha={"w": pm[lvl]["fc_alpha"]["w"],
                                          "b": pm[lvl]["fc_alpha"]["b"] + 0.5})
    ds = SyntheticFaceDataset(kind="audio", num_frames=4, H=32, W=32,
                              near=cfg.dataset.near, far=cfg.dataset.far)
    split = jfm._PE_SPLIT_DOT
    for frame, keyn in [(0, 7), (2, 9), (0, 9), (3, 3), (1, 21), (2, 5)]:
        item = dict(ds[frame])
        item["background"] = ds.background()
        key = jax.random.PRNGKey(keyn)
        g64 = port_grads(False, pm, item, key, torch.float64)
        jfm._PE_SPLIT_DOT = True
        sides = {"jax_fused": jax_grads(cfg, pm, item, key)}
        jfm._PE_SPLIT_DOT = False
        sides["jax_fused_exact_pe"] = jax_grads(cfg, pm, item, key)
        jfm._PE_SPLIT_DOT = split
        sides["jax_plain"] = jax_grads(tiny_cfg(use_pallas=False), pm, item, key)
        sides["port_fused"] = port_grads(True, pm, item, key, torch.float32)
        sides["port_plain"] = port_grads(False, pm, item, key, torch.float32)
        print(f"frame {frame} key {keyn}:")
        for name, g in sides.items():
            rows = sorted(((rel(x, y), p) for p, x, y in _tree_pairs(g, g64)), reverse=True)
            print(f"  {name:18s} " + "; ".join(f"{p.replace('grads.', '')} {r:.2e}"
                                               for r, p in rows[:3]), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    {"eval": eval_readings, "grads": grads_readings}[sys.argv[1]]()
