"""The ``flash_attention`` kernel as an autograd function, in the model layout.

``FlashAttention.apply(q, k, v, causal, window)`` takes ``(B, S, H, D)``
CUDA tensors, as ``ops.attention`` does.  Its forward is one launch of the
``flash_attention`` kernel that also returns each query row's log-sum-exp;
its backward is the two ``flash_attention_bwd`` kernels (``backward.py``),
which recompute the probabilities from that log-sum-exp.  ``ops.attention``
takes this route on the card whenever an input requires a gradient, and the
plain kernel launch otherwise, so serving is unchanged.  The reference's
Pallas kernel has no backward; its model's gradient is XLA's autodiff of
the plain attention, which is what the port's CPU route differentiates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.backward import flash_attention_bwd
from repro_torch.kernels.flash_attention.flash_attention import flash_attention

__all__ = ["FlashAttention"]


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, window=window, return_lse=True)
        o = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, dout))
        dq, dk, dv = flash_attention_bwd(qt, kt, vt, ot, lse, dot,
                                         causal=ctx.causal, window=ctx.window)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2), None, None
