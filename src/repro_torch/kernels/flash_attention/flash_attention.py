"""Wrapper of the CUDA ``flash_attention`` kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention/flash_attention.py::flash_attention``
for any ``Sq``, ``Sk`` (no tile-multiple asserts) and ``D``, ``Dv`` up to
256.  Takes the reference's ``(B, H, S, D)`` layout as tensors or strided
views whose last axis is contiguous, and KV heads that divide the query
heads (query head h reads KV head ``h // (H // Hkv)``, as a repeat of the
KV heads would give).  ``window=W > 0`` is a sliding window: query row i
sees the keys above i − W (and, causal, none past i), as the reference's
``attention_full(window=W)`` does, and tiles wholly below it are skipped;
Sq − W must be below Sk, so that every row has a key.  bf16 inputs (the
model's) go to the tensor-core kernel (``wgmma`` products, K/V tiles fed by
TMA into a 2-3 stage ring), float32 inputs to the scalar float32 kernel; either is one launch of
``flash_attention``, and the path it took is counted in ``build.PATHS``:
``flash_attention.tma``, ``flash_attention.loads`` (a bf16 view whose base
or strides TMA cannot read, loaded by the producer warps instead) or
``flash_attention.simt``.  With ``return_lse=True`` it also returns each
query row's float32 log-sum-exp of its scaled scores, ``(B, H, Sq)``, which
the backward kernels (``backward.py``) read; without it the kernel stores
nothing more.  The plain version is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["MAX_HEAD_DIM", "flash_attention"]

NAME = "flash_attention"
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the entry point's `path` codes (kPathSimt, kPathTma, kPathLoads)
_PATHS = ("simt", "tma", "loads")


def bind(lib: ctypes.CDLL):
    """The typed entry point ``flash_attention_launch`` of a loaded library."""
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn():
    return bind(build.library(NAME))


def _check(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"flash_attention {what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"flash_attention {what}: expected {dtype}, got {t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention {what}: expected 4 dims with a contiguous last "
                         f"axis, got shape {tuple(t.shape)} strides {t.stride()}")


def flash_attention(
    q: torch.Tensor,   # (B, H, Sq, D)
    k: torch.Tensor,   # (B, Hkv, Sk, D)
    v: torch.Tensor,   # (B, Hkv, Sk, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    return_lse: bool = False,
):
    """(B, H, Sq, Dv) attention in q's type, laid out in memory as q is;
    with ``return_lse``, also the (B, H, Sq) float32 row log-sum-exp."""
    return launch_with(_fn, q, k, v, causal=causal, window=window, return_lse=return_lse)


def launch_with(entry, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int = 0, return_lse: bool = False):
    """:func:`flash_attention` through the entry point that ``entry()`` gives
    (see :func:`bind`), asked for once the inputs have passed their checks."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, what, q.dtype)
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape != (b, hkv, sk, d) or v.shape[:3] != (b, hkv, sk):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if h % hkv:
        raise ValueError(f"flash_attention: {hkv} KV heads do not divide {h} query heads")
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {d}/{dv} exceed {MAX_HEAD_DIM}")
    if window < 0 or (window > 0 and sq - window >= sk):
        raise ValueError(f"flash_attention: window {window} leaves some of {sq} query rows "
                         f"without a key of {sk} (need 0, or Sq - window < Sk)")
    # the output takes q's memory order: (B, S, H, Dv) for a transposed model-layout q
    if q.stride(1) < q.stride(2):
        out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty((b, h, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    if sq == 0 or sk == 0 or b * h == 0:
        out.zero_()
        return (out, lse.fill_(-torch.inf)) if return_lse else out
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    device, stream = build.stream_of(q)
    path = ctypes.c_int(-1)
    err = entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
                  b, h, hkv, sq, sk, d, dv, int(causal), int(window), d ** -0.5,
                  _DTYPES[q.dtype],
                  device, stream, ctypes.byref(path), None if lse is None else lse.data_ptr())
    build.check(err, NAME)
    build.LAUNCHES[NAME] += 1
    build.PATHS[f"{NAME}.{_PATHS[path.value]}"] += 1
    return (out, lse) if return_lse else out
