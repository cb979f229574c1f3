"""Batched ALAC LPC analysis kernels.

ALAC (reference ``/root/reference/src/encoders/alac.c`` and spec
``audiotools/py_encoders/alac.py``) is a fundamentally *adaptive*
codec: its residual computation mutates the predictor per sample and
its Rice variant carries a running history — true recurrences that
belong on the host (C++ emitter ``atpu_alac_emit_framesets``).  What
IS batchable — and shared with the FLAC pipeline — is the front half:
tukey windowing, autocorrelation (9 lags), Levinson-Durbin and the
error-feedback coefficient quantization, evaluated for every
(block, channel-group, interlacing-leftweight, channel) candidate in
one array program.  This module computes those coefficient tables;
decisions (order 4 vs 8, leftweight, compressed vs verbatim) are made
by the emitters from exact candidate bit sizes.

Numerics follow the contraction-immune spec in ``ops.lpc``; the
scalar oracle (``ref/alac.py``) calls the same primitives, so fast
and oracle paths are byte-identical by construction.
"""

from __future__ import annotations

import numpy as np

from . import lpc as lpc_ops
from .flac_frames import _scope

QLP_SHIFT_NEEDED = 9
N_LEFTWEIGHTS = 5          # leftweight candidates 0..4

# packed per-(block, group, leftweight, channel) layout:
#   cols 0..3  qlp order-4 coefficients
#   cols 4..11 qlp order-8 coefficients
#   col 12     degenerate flag (windowed autocorrelation[0] == 0)
#   col 13     order-4 residual-size estimate (see
#              residual_estimate; selects order and leftweight)
#   col 14     order-8 residual-size estimate
PACKED_COLS = 15


def alac_quantize(xp, coeff_row):
    """ALAC error-feedback quantization of one order's coefficients

    coeff_row: f64 [..., order] (f32-valued, from levinson)
    returns int32 [..., order]; scale 2^9, clamp to signed 16 bits
    (reference py_encoders/alac.py:336-347).  The scale is an exact
    power of two so every product is exact (contraction-immune)."""
    qlp_max = (1 << 15) - 1
    qlp_min = -(1 << 15)
    order = coeff_row.shape[-1]
    error = xp.zeros(coeff_row.shape[:-1], dtype=xp.float64)
    cols = []
    for j in range(order):
        # f32 re-round keeps the integer rounding's input identical
        # under IEEE f64 and float-float f64 (see ops/lpc.py)
        candidate = lpc_ops.f32round(
            xp, error + coeff_row[..., j] * float(1 <<
                                                  QLP_SHIFT_NEEDED))
        q = xp.clip(xp.round(candidate), qlp_min, qlp_max)
        error = candidate - q
        cols.append(q.astype(xp.int32))
    return xp.stack(cols, axis=-1)


def correlate(xp, ch0, ch1, shift, leftweight):
    """ALAC channel interlacing (py_encoders/alac.py:270-280)

    int32-exact for <= 17-bit inputs; leftweight 0 passes through"""
    if leftweight == 0:
        return (ch0, ch1)
    correlated0 = ch1 + (((ch0 - ch1) * leftweight) >> shift)
    correlated1 = ch0 - ch1
    return (correlated0, correlated1)


def residual_estimate(xp, X, qlp, order):
    """integer-exact estimate of a candidate's residual magnitude

    X: int32 [S, n]; qlp: int32 [S, order].  Computes the
    NON-adaptive ALAC-form residuals
    ``e_i = x_i - base_i - ((sum_j q_j (x_{i-1-j} - base_i)) >> 9)``
    (base_i = x_{i-order-1}) over i in [order+1, n) and returns
    ``min(floor(sum|e_i| / 64), 2^31-1)`` as int32.

    This is a RANKING metric for the order/leftweight selection
    policy shared by the oracle and the C++ emitter: the adaptive
    residuals the emitter actually codes track these within a few
    percent, and one estimated-best pass replaces exact sizing of
    every candidate.  All arithmetic is exact in f64 (products
    <= 2^36, sums <= 2^40 — below even the float-float bound of
    ~2^47) so numpy and every jax backend agree bitwise."""
    n = X.shape[1]
    count = n - 1 - order
    if count <= 0:
        return xp.zeros((X.shape[0],), dtype=xp.int32)
    Xf = X.astype(xp.float64)
    qf = qlp.astype(xp.float64)
    conv = xp.zeros((X.shape[0], count), dtype=xp.float64)
    for j in range(order):
        conv = conv + qf[:, j:j + 1] * Xf[:, order - j:n - 1 - j]
    base = Xf[:, 0:count]
    Q = xp.sum(qf, axis=1)[:, None]
    # multiply by the exact power-of-two reciprocal — float-float
    # division is approximate, scaling is exact
    shifted = xp.floor((conv - base * Q) *
                       (1.0 / float(1 << QLP_SHIFT_NEEDED)))
    e = Xf[:, order + 1:n] - base - shifted
    total = xp.sum(xp.abs(e), axis=1)
    return xp.minimum(xp.floor(total * (1.0 / 64.0)),
                      float((1 << 31) - 1)).astype(xp.int32)


def lpc_candidates(xp, X, window):
    """windowed LPC coefficient candidates for a batch of channels

    X: int32 [S, n] (post-LSB-shift, possibly correlated)
    returns int32 [S, PACKED_COLS]: qlp4, qlp8, degenerate flag,
    order-4/order-8 residual-size estimates"""
    with _scope(xp, "alac_autocorr"):
        autocorr = lpc_ops.windowed_autocorr_df(
            xp, X, window, 8)                      # df pair [S, 9]
    degenerate = (autocorr[0][:, 0] == 0.0)
    with _scope(xp, "alac_levinson"):
        (coeffs, _errors) = lpc_ops.levinson_df(xp, autocorr, 8)
    with _scope(xp, "alac_quantize"):
        qlp4 = alac_quantize(xp, coeffs[:, 3, :4])              # [S, 4]
        qlp8 = alac_quantize(xp, coeffs[:, 7, :8])              # [S, 8]
    qlp4 = xp.where(degenerate[:, None], 0, qlp4)
    qlp8 = xp.where(degenerate[:, None], 0, qlp8)
    with _scope(xp, "alac_residual_estimate"):
        est4 = residual_estimate(xp, X, qlp4, 4)
        est8 = residual_estimate(xp, X, qlp8, 8)
    return xp.concatenate(
        [qlp4, qlp8, degenerate[:, None].astype(xp.int32),
         est4[:, None], est8[:, None]], axis=1)


def analyze_framesets_packed(xp, blocks, layout, bps, lsb_shift,
                             interlacing_shift, min_leftweight,
                             max_leftweight, window):
    """LPC candidates for every (block, group, leftweight, channel)

    blocks: int [B, n, ch_total] in WAVE order (original samples)
    layout: list of (alac_offset, width) groups over the ALAC-reordered
            channels — callers pass channels already reordered so the
            group offsets index blocks' channel axis directly
    lsb_shift: bps-16 for >16-bit streams (samples are shifted before
            analysis; the emitter carries the LSBs verbatim)

    returns packed int32 [B, G, N_LEFTWEIGHTS, 2, PACKED_COLS];
    width-1 groups populate only [:, g, 0, 0] (the rest is zero)"""
    B = blocks.shape[0]
    series = []          # list of int32 [B, n]
    slots = []           # (group, leftweight, channel) per series
    for (g, (offset, width)) in enumerate(layout):
        if width == 1:
            ch = blocks[:, :, offset].astype(xp.int32) >> lsb_shift
            series.append(ch)
            slots.append((g, 0, 0))
        else:
            c0 = blocks[:, :, offset].astype(xp.int32) >> lsb_shift
            c1 = blocks[:, :, offset + 1].astype(xp.int32) >> lsb_shift
            for lw in range(min_leftweight, max_leftweight + 1):
                (s0, s1) = correlate(xp, c0, c1, interlacing_shift, lw)
                series.append(s0)
                slots.append((g, lw, 0))
                series.append(s1)
                slots.append((g, lw, 1))
    with _scope(xp, "alac_correlate_stack"):
        X = xp.concatenate(series, axis=0)      # [B * n_series, n]
    packed_rows = lpc_candidates(xp, X, window)
    packed_rows = xp.reshape(packed_rows,
                             (len(series), B, PACKED_COLS))

    G = len(layout)
    # scatter each series into its (group, leftweight, channel) slot
    full = xp.zeros((B, G, N_LEFTWEIGHTS, 2, PACKED_COLS),
                    dtype=xp.int32)
    for (i, (g, lw, ch)) in enumerate(slots):
        if xp is np:
            full[:, g, lw, ch] = packed_rows[i]
        else:
            full = full.at[:, g, lw, ch].set(packed_rows[i])
    return full
