"""The comparison refuses a broken timed path: a run of each cell (and of
each candidate cell) on the CPU at a small size, with the port's plain path
broken underneath, ends with ``correct`` false; and the control, the
reference in float8 in the program's place, reads above a limit of each
cell of BENCHMARK.json."""
import pytest
import torch

from conftest import PLAIN, tiny, workloads
from port_bench import control, run

WORKLOADS = workloads()
FRAMES = [w for w in WORKLOADS if run.cell(w, True)["traffic"]["driver"] == "frames"]
TRAIN = [w for w in WORKLOADS if run.cell(w, True)["traffic"]["driver"] == "train"]


def cpu_run(workload):
    out = run.run_cell(workload, 2**32 + 5, 0.3, False, device="cpu", config_over=PLAIN,
                       traffic_over=tiny(workload), candidates=True)
    return out["result"]["correct"], out["checks"]


def _wrap_render(monkeypatch, alter):
    import sahs_tpu_torch.evaluation as ev
    real = ev.render_image

    def broken(*a, **k):
        out = real(*a, **k)
        out["rgb_fine"] = alter(out["rgb_fine"].clone())
        return out
    monkeypatch.setattr(ev, "render_image", broken)


def _pixel_altered(x):
    x[3, 4, 0] += 0.3
    return x


def _half_the_rays(x):
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0] // 2
    flat[n:2 * n] = flat[:n]
    return x


@pytest.mark.parametrize("workload", FRAMES)
@pytest.mark.parametrize("fault", [_pixel_altered, _half_the_rays])
def test_frame_faults_are_refused(monkeypatch, workload, fault):
    _wrap_render(monkeypatch, fault)
    correct, checks = cpu_run(workload)
    assert not correct, checks


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from sahs_tpu_torch.train import stage1
    real = stage1.weighted_ray_indices

    def half(*a, **k):
        idx = real(*a, **k)
        n = idx.shape[0] // 2
        return torch.cat([idx[:n], idx[:idx.shape[0] - n]])
    monkeypatch.setattr(stage1, "weighted_ray_indices", half)


def _one_leaf_moved_double(monkeypatch):
    real = torch.optim.Adam.step

    def step(self, closure=None):
        p = self.param_groups[0]["params"][0]
        before = p.detach().clone()
        out = real(self, closure)
        with torch.no_grad():
            p.add_(p - before)
        return out
    monkeypatch.setattr(torch.optim.Adam, "step", step)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _one_leaf_moved_double])
def test_train_faults_are_refused(monkeypatch, workload, fault):
    fault(monkeypatch)
    correct, checks = cpu_run(workload)
    assert not correct, checks


@pytest.mark.parametrize("workload", workloads(candidates=False))
def test_the_control_is_refused(workload):
    driver = run.cell(workload)["traffic"]["driver"]
    small = ({"height": 16, "width": 16, "chunk": 64, "inputs": 2, "ref_block": 64}
             if driver == "frames" else
             {"height": 32, "width": 32, "frames": 4, "rays": 256, "ref_block": 256})
    got = control.readings(workload, 2**31 + 77, "cpu", traffic_over=small, frames=(0,))
    got = got.get("control", got)
    limits = run.cell(workload)["limits"]
    assert any(got[k] > limits[k] for k in limits), (got, limits)
