"""The yardstick reproduces the bound column of the port's kernel table at
the flagship's shapes (bf16 at 989 TFLOP/s): K1 and K5 at a frame's fine
chunk (32,768 rays x 128), K2, K3 and K2's pair= form at a step's fine
level (2,048 x 128)."""
import json
import os

import pytest

from conftest import ROOT
from port_bench import arith, shapes

SPEC = shapes.spec_of(json.load(open(os.path.join(ROOT, "port_bench/configs/audio_p1.json")))[
    "config"])
FINE = 2048 * 128


@pytest.mark.parametrize("what,ms", [
    ("K1", 1.078), ("K5", 6.242), ("K2", 1.170), ("K3", 0.189), ("K2 pair=", 1.360)])
def test_bound_column(what, ms):
    got = {"K1": lambda: arith.bound(*arith.k1_call(SPEC, 32768, 128))[0],
           "K5": lambda: arith.bound(*arith.k5_call(SPEC, "fine", 32768, 128))[0],
           "K2": lambda: arith.bound(2 * arith.level_train_macs(SPEC, "fine") * FINE, 0)[0],
           "K3": lambda: arith.bound(2 * arith.pair_vjp_macs(SPEC) * FINE, 0)[0],
           "K2 pair=": lambda: arith.bound(2 * (arith.level_train_macs(SPEC, "fine")
                                                + arith.pair_vjp_macs(SPEC)) * FINE, 0)[0]}[what]()
    assert round(got, 3) == ms


def test_layout_counts_the_flagship_parameters():
    # the ray group's all-reduce bucket of the flagship's gradients (PERF.md) is
    # 2,775,652 floats: these parameters and 19 metric sums
    assert sum(n for n in (__import__("math").prod(s) for _, s, _ in shapes.layout(SPEC))) \
        == 2775652 - 19


def test_kernel_names_group_by_owner():
    raw = "void (anonymous namespace)::ldw::level_dw_kernel<4>(float*, int)"
    assert arith.short_name(raw) == "ldw::level_dw_kernel<4>"
    assert arith.owner(arith.short_name(raw)) == "dW of K2, K6, K8, K12, K3, K14"
