"""The roundings of the bf16 tensor-core ``flash_attention`` kernel, in PyTorch.

The kernel (``kernels/csrc/flash_attention.cu``, path ``sm90``) differs from the plain version (float32 throughout, the scale
applied to q) in three places, which this helper reproduces:

- the scores are the unscaled float32 products q·kᵀ, and the scale enters
  as one float32 factor ``D^-½ · log2(e)`` in ``p = 2^(s·c − m)``;
- the softmax runs online over tiles of ``block_k`` keys: the running max
  ``m`` (in the scaled base-2 domain), the float32 denominator, and the
  accumulator rescaled by ``2^(m_old − m_new)`` at each tile;
- each tile's ``p`` is rounded to bf16 before ``p·v`` (the denominator sums
  the float32 ``p``).

What it does not reproduce is the order of the float32 sums inside the
tensor cores and the error of ``ex2.approx``.  Both move a float32 ``p`` by
a few parts in 2^23 at most, which changes nothing once ``p`` is rounded to
bf16, unless ``p`` lies that close to a bf16 rounding tie: then the kernel
and the emulation may round it to neighbouring bf16 values, and the output
moves by up to that bf16 ulp of ``p`` times ``|v| / l``.  With
``slack=True`` :func:`bf16_path` also returns, for each output, the sum of
those moves over the keys whose ``p`` lies within the kernel's rounding
window of a tie (zero where none does); :func:`beyond` marks the outputs
that are further from the emulation than one bf16 ulp plus that slack.
The rest of the difference moves the float32 output by far less than a
bf16 ulp of it, which the one ulp of the final rounding covers.
KV heads must be expanded (``repeat_interleave``) by the caller.  The card
tests and ``chip_smoke.py`` hold the kernel to it so; the CPU tests hold it
to the plain version and the Pallas kernel.

:func:`bf16_backward` does the same for the bf16 tensor-core backward
kernels (``kernels/csrc/flash_attention_bwd.cu``): the scores and dP as
float32 products, P = 2^(fma(S, D^-½·log2(e), −L·log2(e))) with the
forward's row log-sum-exp L, dS = P ∘ (dP − Δ), P and dS rounded to bf16
before the products, dQ summed over key tiles in order, dK and dV over the
query heads of a group and their query tiles in order (two alternating
partial sums added at the end where the kernel's two consumers share a
block's keys), each scaled and rounded once.  :func:`bwd_tiles` is the
kernel's table of instances and tiles.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ref import live_keys

__all__ = ["beyond", "bf16_backward", "bf16_path", "bwd_tiles", "key_tile"]

f32 = torch.float32


def key_tile(d: int, dv: int) -> int:
    """The kernel's key tile Bc: 128 keys up to a padded head dim of 128, else 64."""
    return 128 if max(d, dv) <= 128 else 64


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(f32)


def bf16_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              block_k: int, slack: bool = False, window: int = 0):
    """(B, H, Sq, Dv) in q's type, from (B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, Dv),
    the softmax online over tiles of ``block_k`` keys (the kernel's: :func:`key_tile`),
    with the sliding ``window`` of ``ref.flash_attention_ref``.  A tile whose
    keys a row does not see leaves that row's state as it was (−inf, 0, 0
    before its first seen key), so the kernel's skipping of tiles wholly
    below the window or above the diagonal changes no bit.

    With ``slack``, returns ``(out, slack)``: slack (B, H, Sq, Dv) float32 is
    how far the kernel's float32 output may lie from the emulation's before
    either is rounded to bf16, through p's rounded to the other side of a
    bf16 tie.  A score's float32 sum of D products is
    within ``D·2^-23·Σ|q_d·k_d|`` of exact in either
    order (the tensor cores may truncate), counted twice (kernel and
    emulation); the exponent ``s·c − m`` adds the largest such bound of the
    row (the max's) and two roundings of its size, and each
    ``exp2`` (``ex2.approx`` and the emulation's) at most 2 ulps.  A ``p``
    whose window ``p·(1 ± w)`` holds a bf16 rounding tie contributes the
    width of its bf16 rounding range times ``|v|``.
    """
    sq, d = q.shape[-2], q.shape[-1]
    sk = k.shape[-2]
    c = torch.tensor(d ** -0.5, dtype=f32) * torch.tensor(math.log2(math.e), dtype=f32)
    c = c.to(q.device)
    s = q.to(f32) @ k.to(f32).transpose(-1, -2)
    keep = live_keys(sq, sk, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, -torch.inf)
    shape = q.shape[:-1]
    m = torch.full(shape, -torch.inf, dtype=f32, device=q.device)
    l = torch.zeros(shape, dtype=f32, device=q.device)
    o = torch.zeros((*shape, v.shape[-1]), dtype=f32, device=q.device)
    if slack:
        # bound of |kernel's − emulation's| scaled score: D·2^-23·Σ|q·k|
        # each (the kernel's sums may truncate), and the row max's
        gamma = 2.0 * d * 2.0 ** -23 * float(c)
        qa, ka = q.to(f32).abs(), k.to(f32).abs()
        s_err_max = torch.stack([
            (qa @ ka[..., k0:k0 + block_k, :].transpose(-1, -2)).amax(dim=-1)
            for k0 in range(0, sk, block_k)]).amax(dim=0) * gamma
        flips = torch.zeros_like(o)                       # Σ width of p's bf16 range · |v|
    for k0 in range(0, sk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1) * c)
        neg_m = torch.where(m_new == -torch.inf, 0.0, -m_new)
        corr = torch.exp2(m + neg_m)
        p = torch.exp2(torch.addcmul(neg_m[..., None], st, c))
        l = l * corr + p.sum(dim=-1)
        vt = v[..., k0:k0 + block_k, :].to(f32)
        pv = _bf16(p) @ vt
        o = o * corr[..., None] + pv
        if slack:
            s_err = gamma * (qa @ ka[..., k0:k0 + block_k, :].transpose(-1, -2))
            dx = (s_err + s_err_max[..., None]
                  + 2.0 ** -22 * ((st * c).abs() + m_new.abs()[..., None]))
            w = torch.where(p > 0, math.log(2.0) * 1.01 * dx + 2.0 ** -21, 0.0)
            width = _bf16(p * (1 + w)) - _bf16(torch.clamp(p * (1 - w), min=0.0))
            flips = flips * corr[..., None] + width @ vt.abs()
        m = m_new
    l = torch.clamp(l, min=1e-30)[..., None]
    out = (o / l).to(q.dtype)
    return (out, flips / l) if slack else out


def beyond(got: torch.Tensor, emulated: torch.Tensor, slack: torch.Tensor, *, rtol: float,
           atol: float) -> torch.Tensor:
    """The outputs further from the emulation than ``atol + rtol·|emulated|``
    (one bf16 ulp of the final rounding) plus their ``slack``."""
    g, e = got.to(f32), emulated.to(f32)
    return (g - e).abs() > atol + rtol * e.abs() + slack


#: the backward kernels' instances: accumulator widths (DN, DVN) along D and Dv
BWD_INSTANCES = ((64, 64), (80, 80), (128, 128), (192, 128), (256, 256))
#: keys of a dK/dV block
BWD_BLOCK_KEYS = 64


def bwd_tiles(d: int, dv: int) -> dict:
    """The backward kernels' instance for head dims (d, dv): the first of
    :data:`BWD_INSTANCES` that holds both (``dn``, ``dvn``), the dQ kernel's
    key tile ``block_k``, the dK/dV kernel's query tile ``block_q`` and
    whether its two consumers split dK and dV (``roles``) or share the
    block's tiles (alternate tiles, two sums added at the end)."""
    dn, dvn = next(w for w in BWD_INSTANCES if d <= w[0] and dv <= w[1])
    roles = dn + dvn > 256
    acc = max(dn, dvn) // 2 if roles else (dn + dvn) // 2
    return dict(dn=dn, dvn=dvn, block_k=64 if dn // 2 <= 96 else 32,
                block_q=64 if acc <= 96 else 32, roles=roles)


def bf16_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, *, causal: bool, window: int = 0):
    """(dq, dk, dv) in q's type, as the bf16 backward kernels compute them,
    from (B, H, Sq, D) q, (B, Hkv, Sk, D) k, (B, Hkv, Sk, Dv) v, the
    forward's output o and its gradient do (B, H, Sq, Dv), and the
    forward's row log-sum-exp lse (B, H, Sq) float32.

    What it does not reproduce is the order of the float32 sums inside the
    tensor cores (within a tile) and the error of ``ex2.approx``: both move
    a float32 P or dS by a few parts in 2^23, which changes its bf16 value
    only where it lies that close to a bf16 rounding tie."""
    b, h, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    t = bwd_tiles(d, dv)
    dev = q.device
    scale = torch.tensor(d ** -0.5, dtype=f32, device=dev)
    log2e = torch.tensor(math.log2(math.e), dtype=f32, device=dev)
    c = (scale.cpu() * log2e.cpu()).item()   # the kernel's float32 D^-½·log2(e)
    qf, kf, vf, of, dof = (x.to(f32) for x in (q, k, v, o, do))
    kr, vr = kf.repeat_interleave(g, dim=1), vf.repeat_interleave(g, dim=1)
    lb = lse.to(f32) * log2e
    # fma(s, c, -lb), rounded once: the product of two floats is exact in float64
    x = (torch.matmul(qf, kr.transpose(-1, -2)).double() * c - lb.double()[..., None]).to(f32)
    keep = live_keys(sq, sk, causal, window, dev)
    if keep is not None:
        x = torch.where(keep, x, -torch.inf)
    p = torch.exp2(x)
    delta = (dof * of).sum(dim=-1)
    ds = p * (dof @ vr.transpose(-1, -2) - delta[..., None])
    p16, ds16 = _bf16(p), _bf16(ds)
    bk, bq = t["block_k"], t["block_q"]
    dq = torch.zeros_like(qf)
    for k0 in range(0, sk, bk):
        dq = dq + ds16[..., k0:k0 + bk] @ kr[..., k0:k0 + bk, :]
    dq = (dq * scale).to(q.dtype)
    # dK and dV of each block of 64 keys: its query heads in order and, for
    # each, the tiles of block_q rows that see its keys (tiles of no live
    # pair add zeros, which change no sum)
    p16 = p16.reshape(b, hkv, g, sq, sk)
    ds16 = ds16.reshape(b, hkv, g, sq, sk)
    qg, dog = qf.reshape(b, hkv, g, sq, d), dof.reshape(b, hkv, g, sq, dv)
    dk = torch.empty((b, hkv, sk, d), dtype=f32, device=dev)
    dvv = torch.empty((b, hkv, sk, dv), dtype=f32, device=dev)
    for k0 in range(0, sk, BWD_BLOCK_KEYS):
        k1 = min(k0 + BWD_BLOCK_KEYS, sk)
        i_lo = k0 if causal else 0
        i_hi = min(sq, k1 - 1 + window) if window > 0 else sq
        sums = [[torch.zeros((b, hkv, k1 - k0, d), dtype=f32, device=dev),
                 torch.zeros((b, hkv, k1 - k0, dv), dtype=f32, device=dev)] for _ in range(2)]
        n = 0
        for hq in range(g):
            for i0 in range(i_lo, i_hi, bq):
                i1 = min(i0 + bq, sq)
                part = sums[0 if t["roles"] else n % 2]
                part[0] = part[0] + ds16[:, :, hq, i0:i1, k0:k1].transpose(-1, -2) @ qg[:, :, hq,
                                                                                        i0:i1]
                part[1] = part[1] + p16[:, :, hq, i0:i1, k0:k1].transpose(-1, -2) @ dog[:, :, hq,
                                                                                        i0:i1]
                n += 1
        dk[:, :, k0:k1] = sums[0][0] + sums[1][0]
        dvv[:, :, k0:k1] = sums[0][1] + sums[1][1]
    return dq, (dk * scale).to(q.dtype), dvv.to(q.dtype)
