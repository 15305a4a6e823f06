"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
top-level name of each module; the reference loads nothing of the port."""
import os
import subprocess
import sys

from conftest import ROOT

MODULES = ["port_bench.run", "port_bench.control", "port_bench.arith", "port_bench.trace",
           "port_bench.kernels",
           "port_bench.inputs", "port_bench.weights", "port_bench.reference.model",
           "port_bench.reference.frames", "port_bench.reference.train",
           "port_bench.reference.precision"]


def loaded_after(code):
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                           "sorted({m.split('.')[0] for m in sys.modules})))"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_harness_drivers_readers_and_reference_load_no_jax():
    code = "\n".join(f"import {m}" for m in MODULES) + """
import glob, os
from port_bench import run
for sub in ("drivers", "layer_metrics"):
    for path in sorted(glob.glob(os.path.join("port_bench", sub, "*.py"))):
        run.load_module(path, "m_" + os.path.basename(path)[:-3].replace(".", "_"))
"""
    top = loaded_after(code)
    assert not top & {"jax", "jaxlib", "flax", "sahs_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    top = loaded_after("import port_bench.reference.train, port_bench.reference.frames, "
                       "port_bench.reference.precision, port_bench.weights")
    assert "sahs_tpu_torch" not in top and "sahs_tpu" not in top


def test_a_run_loads_no_jax():
    code = """
from port_bench import run
run.run_cell("audio_p1.frames", 5, 0.2, False, device="cpu",
             config_over={"runtime": {"use_pallas": False}},
             traffic_over={"height": 8, "width": 8, "chunk": 32, "inputs": 2, "warmup": 1,
                           "check_frames": 1, "ref_block": 32})
"""
    top = loaded_after(code)
    assert "sahs_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "sahs_tpu"}
