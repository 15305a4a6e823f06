"""Products of the reference at lower precisions.

``fp8_linear`` is the control's: every product of the field with its
operands rounded to float8 e4m3, a per-tensor scale taking each operand's
largest magnitude to the format's largest value (448), sums in float32; in
the backward the cotangent is rounded the same way. It is the step below
the bf16 operands that the configurations state, the one a later change
could be tempted to take, and the comparison that decides ``correct`` has
to refuse it.

``bf16_linear`` is the configurations' own precision, the yardstick of a
frame's comparison: how far bf16 operands alone move the reference's frame
from its float32 one.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        qx, qw = fp8(x), fp8(w)
        ctx.save_for_backward(qx, qw)
        return torch.addmm(b, qx, qw.t())

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qw, qg.t() @ qx, g.sum(0)


def fp8_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Linear.apply(x, w, b)


def bf16_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The precision the configurations state: bf16 operands, float32 sums
    and bias (the kernels' products)."""
    return torch.addmm(b, x.to(torch.bfloat16).to(torch.float32),
                       w.to(torch.bfloat16).to(torch.float32).t())
