"""Wrapper of the CUDA backward kernels of ``flash_attention`` (``csrc/flash_attention_bwd.cu``).

The Pallas kernel this port replaces has no backward: the reference takes
the attention's gradient by XLA's autodiff of its plain attention.  On the
card the port's forward is the kernel, so its gradient is two kernels too:
``flash_attention_bwd_dq`` (dQ, and the row term Δ = rowsum(dO ∘ O)) and
then ``flash_attention_bwd_dkv`` (dK and dV, each KV head's summed over its
query heads inside one block).  Neither uses atomics, so the same inputs
give the same bits.  They take what the forward takes (causal or not, a
sliding window, Sq ≠ Sk, KV heads that divide the query heads, D and Dv up
to 256, float32 or bf16 views with a contiguous last axis) together with
the forward's output and its row log-sum-exp (``flash_attention(...,
return_lse=True)``), and raise on anything else.  The gradients come back in
q's type and in the memory order of q, k and v.  bf16 inputs (the
model's) go to the tensor-core kernels (``wgmma`` products, tiles fed by
TMA into a ring of stages), float32 inputs to the scalar kernels; each
launch counts its path in ``build.PATHS``: ``<kernel>.tma``,
``<kernel>.loads`` (a bf16 view whose base or strides TMA cannot read,
loaded by the producer warps instead) or ``<kernel>.simt``.  The plain
version is ``ref.flash_attention_bwd_ref``; ``emulation.bf16_backward``
reproduces the bf16 kernels' roundings; ``autograd.py`` wires the kernels
into autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import MAX_HEAD_DIM, _check
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

__all__ = ["DKV", "DQ", "Prepared", "bind", "flash_attention_bwd", "launch", "prepare"]

NAME = "flash_attention_bwd"
DQ = "flash_attention_bwd_dq"
DKV = "flash_attention_bwd_dkv"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the entry points' `path` codes (kPathSimt, kPathTma, kPathLoads)
_PATHS = ("simt", "tma", "loads")


def bind(lib: ctypes.CDLL) -> tuple:
    """The typed entry points (dq, dkv) of a loaded library."""
    fns = []
    for name in (DQ, DKV):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return tuple(fns)


@functools.cache
def _fns():
    return bind(build.library(NAME))


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of t's shape in t's memory order where t is dense,
    else contiguous."""
    return torch.empty_like(t, memory_format=torch.preserve_format)


class Prepared(NamedTuple):
    """One backward call's checked arguments (but the stream, taken at each
    launch) and its outputs (``delta``: the row term Δ, float32 (B, H, Sq),
    written by the dQ kernel)."""

    args: tuple
    device: torch.device
    strides: ctypes.Array
    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    delta: torch.Tensor


def prepare(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0) -> Prepared:
    """Check a backward call's CUDA inputs and allocate its outputs."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd: q must be float32 or bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out"), (dout, "dout")):
        _check(t, what, q.dtype)
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (b, hkv, sk, d) or v.shape[:3] != (b, hkv, sk)
            or out.shape != (b, h, sq, dv) or dout.shape != out.shape):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} do not agree")
    if h % hkv:
        raise ValueError(f"flash_attention_bwd: {hkv} KV heads do not divide {h} query heads")
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    if window < 0 or (window > 0 and sq - window >= sk):
        raise ValueError(f"flash_attention_bwd: window {window} leaves some of {sq} query rows "
                         f"without a key of {sk}")
    if (lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be float32 (B, H, Sq) = {(b, h, sq)} "
                         f"contiguous on {q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dvv = _like(q), _like(k), _like(v)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dvv) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, h, hkv, sq, sk, d, dv, int(causal),
            int(window), d ** -0.5, _DTYPES[q.dtype], q.device.index)
    return Prepared(args, q.device, strides, dq, dk, dvv, delta)


def launch(name: str, prepared: Prepared, fns=None) -> None:
    """Launch the kernel ``name`` (:data:`DQ` or :data:`DKV`) on a prepared
    call; :data:`DKV` reads the Δ that :data:`DQ` wrote.  ``fns``: the
    entry points (dq, dkv) of another loaded library (:func:`bind`), for
    an A/B of two builds."""
    fn = dict(zip((DQ, DKV), fns or _fns()))[name]
    stream = torch.cuda.current_stream(prepared.device).cuda_stream
    path = ctypes.c_int(-1)
    build.check(fn(*prepared.args, stream, ctypes.byref(path)), name)
    build.LAUNCHES[name] += 1
    build.PATHS[f"{name}.{_PATHS[path.value]}"] += 1


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal=, window=)`` for the
    output gradient ``dout``; ``out`` and ``lse`` are the forward's (on the
    CPU the plain version, which recomputes the softmax and needs no lse)."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, out, dout, causal=causal, window=window)
    prepared = prepare(q, k, v, out, lse, dout, causal=causal, window=window)
    if q.numel() and k.numel():
        launch(DQ, prepared)
        launch(DKV, prepared)
    else:
        for t in (prepared.dq, prepared.dk, prepared.dv):
            t.zero_()
    return prepared.dq, prepared.dk, prepared.dv
