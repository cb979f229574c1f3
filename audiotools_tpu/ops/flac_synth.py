"""Batched FLAC subframe synthesis + stereo reconstruction.

The decode-side counterpart of ops/flac_frames.py: predictor inversion
for a batch of subframes as ONE fused scan over sample positions —
the batched form of reference ``src/decoders/flac.c:888-896``
(subframe synthesis) and ``:1213`` (decorrelation).  Each block's
recurrence is seeded from the bitstream's stored warm-up samples, so
blocks are exactly independent (SURVEY.md §7 hard part 3) and the
whole batch advances together: each scan step computes one sample for
all S subframes as a [S, 32] multiply-accumulate.

Exactness: the prediction sum is <= 32 products of |q| < 2^14 and
|s| < 2^26 — every f64 product is exact (< 2^40) and the 32-term sum
stays below 2^45, exactly representable in f64 in any order.  The
arithmetic shift is an exact power-of-two scale + floor.  FIXED subframes run
through the same scan with the fixed coefficient rows
([1], [2,-1], [3,-3,1], [4,-6,4,-1]) and shift 0; CONSTANT and
VERBATIM rows pass through (order 0, zero coefficients).

Backend-generic (``xp`` = numpy oracle or jax.numpy device path),
bit-identical on both.
"""

from __future__ import annotations

import numpy as np

from . import lpc as lpc_ops

K = 32   # static coefficient width (FLAC order <= 32)

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def fill_fixed_qlp(sub_meta, qlp):
    """host-side (numpy): writes the FIXED-predictor coefficient rows
    into the qlp array for subframes of type 2 (sub_meta layout from
    _native.flac_scan); returns qlp (modified copy)"""
    qlp = np.array(qlp, dtype=np.int32, copy=True)
    for order, coeffs in FIXED_COEFFS.items():
        rows = np.nonzero((sub_meta[:, 1] == 2) &
                          (sub_meta[:, 2] == order))[0]
        if len(rows):
            qlp[rows] = 0
            for j, c in enumerate(coeffs):
                qlp[rows, j] = c
    return qlp


def i32_synthesis_safe(qlp, shift, value_bits):
    """host-side guard for the int32 synthesis fast path

    qlp: int32 [S, Kw]; shift: int32 [S]; value_bits: int [S] bound
    on bits of |decoded value| per row (ebps; padded rows zero).

    The int32 recombination pred = (A << (11-s)) + (B >> s) /
    (A + (B >> 11)) >> (s-11) with A = sum q*(v >> 11),
    B = sum q*(v & 2047) is EXACT (not saturating) whenever no
    intermediate can wrap:  per row, with Q = sum|q|,
    * B bound: Q * 2^11 < 2^31
    * A bound: Q * 2^max(vb-11, 0) < 2^30
    * s <= 11 rows additionally: A_bound << (11 - s) < 2^30
    Valid streams keep decoded values within value_bits, so the
    int32 result equals the exact-f64 floor form bit for bit."""
    Q = np.abs(qlp.astype(np.int64)).sum(axis=1).astype(np.float64)
    vb = np.asarray(value_bits, dtype=np.float64)
    a_bound = Q * np.exp2(np.maximum(vb - 11.0, 0.0))
    s = np.asarray(shift, dtype=np.int64)
    lo_ok = a_bound * np.exp2(11.0 - np.minimum(s, 11)) < 2.0 ** 30
    ok = ((Q * 2048.0 < 2.0 ** 31) &
          (a_bound < 2.0 ** 30) &
          np.where(s <= 11, lo_ok, True))
    return bool(np.all(ok))


def synthesize(xp, residuals, warmup, qlp, shift, order, n,
               use_i32=False):
    """inverts the predictors for a batch of subframes

    residuals: int32 [S, n] (CONSTANT rows zero, VERBATIM rows carry
               the raw samples; positions < order are ignored)
    warmup:    int32 [S, Kw] stored warm-up samples (Kw <= K static;
               callers may slice to the batch's max order — the
               per-step multiply-accumulate width is the scan's
               dominant arithmetic, and -8 streams use order <= 12)
    qlp:       int32 [S, Kw] predictor coefficients (FIXED rows carry
               the fixed-difference coefficients, see fill_fixed_qlp)
    shift:     int32 [S] quantization shift (0 for FIXED)
    order:     int32 [S] predictor order (0 = pass-through)
    n:         static block length
    use_i32:   run the int32 form (the caller checked
               i32_synthesis_safe for this batch)

    returns samples int32 [S, n]
    """
    S = residuals.shape[0]
    qf = qlp.astype(xp.float64)                        # [S, Kw]
    scale = lpc_ops.exact_exp2(xp, -shift.astype(xp.int64))  # [S]
    ordv = order.astype(xp.int32)

    Kw = qlp.shape[1]
    # warm-up plane: column i (< order) holds the stored sample
    warm_full = xp.zeros((S, n), dtype=xp.int32)
    kk = min(Kw, n)
    if xp is np:
        warm_full[:, :kk] = warmup[:, :kk]
    else:
        warm_full = warm_full.at[:, :kk].set(warmup[:, :kk])

    if xp is np:
        hist = np.zeros((S, Kw), dtype=np.float64)
        out = np.empty((S, n), dtype=np.int32)
        res_f = residuals.astype(np.float64)
        idx = np.arange(S)
        for i in range(n):
            pred = np.floor(np.sum(qf * hist, axis=1) * scale)
            val = np.where(i < ordv,
                           warm_full[:, i].astype(np.float64),
                           res_f[:, i] + pred)
            v32 = val.astype(np.int64).astype(np.int32)
            out[:, i] = v32
            hist[:, 1:] = hist[:, :-1]
            hist[:, 0] = v32
        return out

    import jax
    import jax.numpy as jnp

    if use_i32:
        # native-int32 path (caller guarantees no intermediate wraps
        # via i32_synthesis_safe).  The value splits
        # v = (v >> 11) * 2^11 + (v & 2047), A/B accumulate the two
        # planes, and the exact shift-split recombination mirrors
        # ops/lpc.lpc_residuals_i32's algebra — identical integers to
        # the f64 floor form by construction.
        qi = qlp.astype(jnp.int32)
        sh = shift.astype(jnp.int32)
        s_le = jnp.minimum(sh, 11)
        sh_hi = jnp.maximum(sh, 11) - 11
        is_lo = sh <= 11

        def one(state, res_i, warm_i, i):
            (hh, hl) = state
            A = jnp.sum(qi * hh, axis=1, dtype=jnp.int32)
            B = jnp.sum(qi * hl, axis=1, dtype=jnp.int32)
            pred_lo = (A << (11 - s_le)) + (B >> s_le)
            pred_hi = (A + (B >> 11)) >> sh_hi
            pred = jnp.where(is_lo, pred_lo, pred_hi)
            val = jnp.where(i < ordv, warm_i, res_i + pred)
            hh = jnp.concatenate([(val >> 11)[:, None],
                                  hh[:, :-1]], axis=1)
            hl = jnp.concatenate([(val & 2047)[:, None],
                                  hl[:, :-1]], axis=1)
            return ((hh, hl), val)

        state0 = (jnp.zeros((S, Kw), dtype=jnp.int32),
                  jnp.zeros((S, Kw), dtype=jnp.int32))
    else:
        def one(state, res_i, warm_i, i):
            hist = state
            pred = jnp.floor(jnp.sum(qf * hist, axis=1) * scale)
            val = jnp.where(i < ordv,
                            warm_i.astype(jnp.float64),
                            res_i.astype(jnp.float64) + pred)
            v32 = val.astype(jnp.int64).astype(jnp.int32)
            hist = jnp.concatenate(
                [v32[:, None].astype(jnp.float64), hist[:, :-1]],
                axis=1)
            return (hist, v32)

        state0 = jnp.zeros((S, Kw), dtype=jnp.float64)

    # U samples per scan step: the recurrence advances sequentially
    # INSIDE the step body (identical arithmetic order), so the scan
    # pays n/U step boundaries instead of n — scan-step overhead was
    # the measured wall of the device decode path
    import os as _os
    U = int(_os.environ.get("ATPU_SYNTH_UNROLL", "16"))
    while n % U:
        U //= 2

    def step(state, xs):
        (res_u, warm_u, i_u) = xs          # [U, S], [U, S], [U]
        outs = []
        for u in range(U):
            (state, v32) = one(state, res_u[u], warm_u[u], i_u[u])
            outs.append(v32)
        return (state, jnp.stack(outs))

    xs = (residuals.T.reshape(n // U, U, S),
          warm_full.T.reshape(n // U, U, S),
          jnp.arange(n, dtype=jnp.int32).reshape(n // U, U))
    (_, ys) = jax.lax.scan(step, state0, xs)
    return ys.reshape(n, S).T                           # [S, n]


def reconstruct_frames(xp, samples, wasted, frame_assignment, ch):
    """wasted-bits restore + stereo decorrelation + interleave

    samples: int32 [F * ch, n] synthesized subframe planes (frame f's
             channels at rows f*ch..f*ch+ch)
    wasted:  int32 [F * ch]
    frame_assignment: int32 [F] FLAC channel assignment (0-7
             independent, 8 left-side, 9 side-right, 10 mid-side)
    ch: static channel count

    returns int32 [F, n, ch] interleaved PCM
    """
    n = samples.shape[1]
    shifted = samples << wasted[:, None]
    F = frame_assignment.shape[0]
    planes = xp.reshape(shifted, (F, ch, n))
    if ch == 2:
        a = frame_assignment[:, None]
        c0 = planes[:, 0]
        c1 = planes[:, 1]
        # mid-side exact reconstruction (reference flac.c:1213)
        msum = (c0 << 1) | (c1 & 1)
        left = xp.where(a == 9, c0 + c1,
                        xp.where(a == 10, (msum + c1) >> 1, c0))
        right = xp.where(a == 8, c0 - c1,
                         xp.where(a == 10, (msum - c1) >> 1, c1))
        planes = xp.stack([left, right], axis=1)
    return xp.swapaxes(planes, 1, 2)                    # [F, n, ch]
