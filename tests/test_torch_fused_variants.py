"""The fused Stage-I step's four structural variants in the port, with the
spatial-embedding grid, against the JAX package's same variants (float32,
Pallas in interpret mode; the port's kernels as their plain versions on
the CPU): each of SAHS_BWD_SPLIT, SAHS_FUSED_UNION, SAHS_PAIR_RAYS and
SAHS_PAIR_FOLD alone, and _PAIR_RAYS with _PAIR_FOLD and with _UNION,
through stage1_fused with the module flag patched on both sides: loss, rgb
and weights within OUT_RTOL of JAX's, every gradient by
assert_step_grads_close; against the port's default step at JAX's own
tolerances (tests/test_fused_train.py: loss 1e-5, gradients rtol 2e-4 /
atol 2e-6; the split 1e-6, rtol 1e-4 / atol 1e-6); then one train_step of
the variant against the default's on the same draws. The grid-free model's
cases and the kernel forms the variants reach are in
tests/test_torch_fused_variant_forms.py; the helpers in
tests/torch_variant_util.py.
"""
import pytest

import torch

from torch_variant_util import (VARIANTS, check_step, check_variant, run_port,
                                run_port_step, variant_setup)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def grid_setup():
    su = variant_setup(True)
    return su, run_port(su, ()), run_port_step(su, ())


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_matches_jax_and_default(grid_setup, name):
    su, default, default_step = grid_setup
    check_variant(su, name, default)
    check_step(su, name, default_step)
