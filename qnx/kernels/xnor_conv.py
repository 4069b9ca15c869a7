"""Packed binary convolution: im2col over packed words + XNOR-popcount GEMM
+ zero-padding correction.

The reference's ``K.conv2d`` on fake-quant weights becomes (SURVEY.md §2.4
"XNOR conv"): patches of channel-packed sign bits are gathered by shifted
slicing (pure XLA data movement), reduced by a packed popcount GEMM, and
corrected for 'SAME' zero-padding.  :func:`conv_rows` / :func:`corr_rows`
lay patches and correction out for the fused kernel
(:func:`qnx.kernels.popcount.popcount_matmul`), with a 2x2 pool as four row
sets, one per window offset.

Zero-padding correction (SURVEY.md §7.4 item 3): a zero pad is a third
symbol in the ±1 domain.  We pad the *packed* input with 0-bits, which
decode to -1, so

    s_packed[b,h,w,n] = s_zero_pad[b,h,w,n] - sum_{taps outside image} w[tap,n]

and the exact zero-pad conv is recovered with a precomputed, input-
independent correction  ``corr[h,w,n] = sum_{pad taps at (h,w)} w[tap,n]``
(built host-side by :func:`padding_correction`).  Interior positions have
corr = 0; only image borders carry nonzero entries.

Layout contract: activations NHWC packed along C (C bits -> Cw words per
position); weights HWIO packed along I per tap, concatenated tap-major
[(dy0,dx0) words..., (dy0,dx1) words...] to match patch extraction order.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from qnx.ops.reference import xnor_gemm_ref
from .popcount import popcount_matmul

Array = jax.Array


def extract_packed_patches(xp: Array, kh: int, kw: int) -> Array:
    """(B, H, W, Cw) packed words -> (B, H, W, kh*kw*Cw) 'SAME' patches.

    Pads with all-zero words (= -1 bits, corrected downstream) and stacks
    the kh*kw shifted views along the last axis, tap-major."""
    b, h, w, cw = xp.shape
    ph, pw = kh // 2, kw // 2
    xpad = jnp.pad(xp, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    taps = [
        xpad[:, dy:dy + h, dx:dx + w, :]
        for dy in range(kh)
        for dx in range(kw)
    ]
    return jnp.concatenate(taps, axis=-1)


def _window_sets(a: Array, pool: bool) -> Array:
    """(..., H, W, C) -> (Q, rows, C): Q = 1, or Q = 4 row sets, one per
    2x2 window offset (dy, dx), each in pooled (h/2, w/2) row order."""
    *lead, h, w, c = a.shape
    if not pool:
        return a.reshape(1, -1, c)
    a = a.reshape(*lead, h // 2, 2, w // 2, 2, c)
    nl = len(lead)
    order = (nl + 1, nl + 3, *range(nl), nl, nl + 2, nl + 4)
    return a.transpose(order).reshape(4, -1, c)


def conv_rows(xp: Array, pool: bool) -> Array:
    """(B, H, W, Cw) packed words -> (Q, B*H'*W', 9*Cw) 3x3 'SAME' patch
    rows for :func:`qnx.kernels.popcount.popcount_matmul`."""
    return _window_sets(extract_packed_patches(xp, 3, 3), pool)


def corr_rows(corr: Array, pool: bool) -> Array:
    """(H, W, N) border correction -> (Q*H'*W', N), matching
    :func:`conv_rows` row sets (row m of set q reads corr[q*R + m % R])."""
    return _window_sets(corr, pool).reshape(-1, corr.shape[-1])


def conv_codes(xp: Array, w: Array, base, corr: Array, sgn: Array,
               tau: Array, *, sign: Array | None = None,
               pool: bool = False) -> Array:
    """Fused packed 3x3 'SAME' conv + border correction (+ 2x2 max pool of
    the conv output) + threshold, one kernel call.

    Args:
      xp: (B, H, W, Cw) int32 channel-packed sign bits.
      w: (9*Cw, N) packed weights, tap-major (:func:`pack_conv_weights_np`);
        the mask plane for ternary weights, with ``sign`` the sign plane.
      base: K = 9*C_in (binary) or (N,) nnz (ternary).
      corr: (H, W, N) int32 zero-pad correction (:func:`padding_correction`).
      sgn, tau: (N,) int32 threshold direction / integer threshold.
    Returns:
      (B, H', W', N) int8 ±1 codes; H' = H/2, W' = W/2 when ``pool``.
    """
    b, h, wd, _ = xp.shape
    code = popcount_matmul(conv_rows(xp, pool), w, base, sign=sign,
                           corr=corr_rows(corr, pool), sgn=sgn, tau=tau)
    if pool:
        h, wd = h // 2, wd // 2
    return code.reshape(b, h, wd, -1)


def pack_conv_weights_np(pattern: np.ndarray):
    """Host-side: (kh, kw, C, N) ±1 pattern -> (kh*kw*Cw, N) packed planes
    matching :func:`extract_packed_patches` order. Returns (wp, k_true)."""
    from qnx.ops.packing import pack_bits_np

    kh, kw, c, n = pattern.shape
    blocks = [
        pack_bits_np(pattern[dy, dx], axis=0)  # (Cw, N)
        for dy in range(kh)
        for dx in range(kw)
    ]
    return np.concatenate(blocks, axis=0), kh * kw * c


def pack_conv_ternary_np(pattern: np.ndarray):
    """Host-side ternary variant: returns (mask, sign, nnz) with shapes
    (kh*kw*Cw, N), (kh*kw*Cw, N), (N,)."""
    from qnx.ops.packing import pack_ternary_np

    kh, kw, c, n = pattern.shape
    masks, signs = [], []
    nnz = np.zeros(n, np.int32)
    for dy in range(kh):
        for dx in range(kw):
            m, s, z = pack_ternary_np(pattern[dy, dx], axis=0)
            masks.append(m)
            signs.append(s)
            nnz += z
    return np.concatenate(masks, 0), np.concatenate(signs, 0), nnz


def padding_correction(pattern: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host-side: corr[h, w, n] = sum over taps falling outside the image of
    sum_c pattern[dy, dx, c, n] (for ±1 or {-1,0,+1} patterns).

    Adding ``corr`` to the packed conv output yields the exact zero-padding
    conv result (see module docstring)."""
    kh, kw, _, n = pattern.shape
    ph, pw = kh // 2, kw // 2
    wsum = pattern.sum(axis=2, dtype=np.int64)  # (kh, kw, n)
    corr = np.zeros((h, w, n), np.int64)
    for dy in range(kh):
        for dx in range(kw):
            oy, ox = dy - ph, dx - pw
            # tap (dy,dx) at output (y,x) reads input (y+oy, x+ox)
            ys = np.arange(h)[:, None] + oy
            xs = np.arange(w)[None, :] + ox
            outside = (ys < 0) | (ys >= h) | (xs < 0) | (xs >= w)
            corr += outside[:, :, None] * wsum[dy, dx][None, None, :]
    return corr.astype(np.int32)


def xnor_conv(xp: Array, wp: Array, k: int, corr: Array,
              kh: int = 3, kw: int = 3) -> Array:
    """Packed binary 'SAME' conv, stride 1: (B,H,W,Cw) x (kh*kw*Cw, N) ->
    exact zero-pad conv output (B,H,W,N) int32."""
    b, h, w, _ = xp.shape
    patches = extract_packed_patches(xp, kh, kw)
    s = xnor_gemm_ref(patches.reshape(b * h * w, -1), wp, k
                      ).reshape(b, h, w, -1)
    return s + corr[None]

