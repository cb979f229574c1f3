"""Batched ALAC subframe synthesis: the sign-adaptive predictor as a
fused scan.

The decode-side counterpart of ops/alac_frames.py and the ALAC sibling
of ops/flac_synth.py (reference ``src/decoders/alac.c``; behavioral
spec ``audiotools/py_decoders/alac.py``, oracle ``ref/alac.py``
``decode_subframe``): the predictor recurrence — prediction from the
last ``order`` samples against a sliding base, THEN a data-dependent
coefficient adaptation walk — runs as ONE ``lax.scan`` over sample
positions with every subframe lane advancing together.

The adaptation walk (``for pn in order-1..0 while residual != 0``)
unrolls to ``max_order`` masked steps inside the scan body: each lane
deactivates when its residual crosses zero, reproducing the C
decoder's early termination exactly.  The positive and negative
branches unify through ``sign = sign(residual_0) * sign(val)`` — the
two C loops are mirror images.

Exactness: samples are < 2^26 (sample_size <= 25 + headroom), the
prediction sum is <= 32 products of int16 coefficients with 27-bit
diffs (< 2^43 total — exact in f64), and the
adaptation arithmetic is pure int32.  Backend-generic (``xp`` = numpy
oracle or jax.numpy device), bit-identical on both.

Residual planes come from the host structural scan
(``_native.atpu_alac_scan``): ALAC's entropy coding adapts its Rice
parameter per sample from decode history, so bit positions are
data-dependent and the bit-serial half stays on host, like the FLAC
decode split.
"""

from __future__ import annotations

import numpy as np

from . import lpc as lpc_ops

K = 32   # static coefficient width (ALAC order < 32)


def _trunc_bits(xp, v, nbits_mask, sign_bit):
    """two's-complement truncation to sample_size bits (per lane)

    v: int (any width, f64-exact); nbits_mask = 2^sample_size - 1,
    sign_bit = 2^(sample_size - 1), both int32 [S]"""
    u = v & nbits_mask
    return (u ^ sign_bit) - sign_bit


def synthesize(xp, residuals, qlp0, order, shift, sample_size, n,
               max_order=8):
    """inverts the sign-adaptive predictor for a batch of subframes

    residuals:   int32 [S, n] decoded residuals (positions past a
                 subframe's count are ignored by the caller)
    qlp0:        int32 [S, K] initial predictor coefficients
    order:       int32 [S]; order >= 31 selects the pure difference
                 chain; order 0 with all-zero qlp passes residuals
                 through unchanged after the i >= 1 diff rule —
                 for RAW (uncompressed) rows use is_raw instead
    shift:       int32 [S] quantization shift
    sample_size: int32 [S] output truncation width in bits
    n:           static block length
    max_order:   static unroll bound for the adaptation walk (lanes
                 with larger orders must not be present)

    returns samples int32 [S, n]
    """
    S = residuals.shape[0]
    ordv = order.astype(xp.int32)
    # order >= 31: every position runs the difference chain
    diff_all = ordv >= 31
    ord_eff = xp.where(diff_all, n, ordv)
    shiftv = shift.astype(xp.int32)
    nmask = ((1 << xp.clip(sample_size, 1, 30)) - 1).astype(xp.int32)
    sbit = (1 << (xp.clip(sample_size, 1, 30) - 1)).astype(xp.int32)

    # per-lane window gather indices (constant through the scan):
    # window w holds the last K+1 samples, newest first
    # (w[j] = data[i-1-j]); the predictor reads w[0..order-1] and
    # base = w[order]; the adaptation's buf[order - pn] at walk step
    # t is w[order - 1 - t]
    t_idx = xp.arange(max_order, dtype=xp.int32)[None, :]
    adapt_idx = xp.clip(ordv[:, None] - 1 - t_idx, 0, K)   # [S, T]
    base_idx = xp.clip(ordv, 0, K)[:, None]                # [S, 1]
    jj = xp.arange(K, dtype=xp.int32)[None, :]
    tap_live = jj < ordv[:, None]                          # [S, K]
    walk_live = t_idx < ordv[:, None]                      # [S, T]
    mult = (ordv[:, None] - (ordv[:, None] - 1 - t_idx)
            ).astype(xp.int32)                             # order - pn

    qf_scale = lpc_ops.exact_exp2(xp, -shiftv.astype(xp.int64))
    half = xp.where(shiftv > 0, (1 << xp.clip(shiftv - 1, 0, 30)), 0)

    def one(window, qlp, res_i, i):
        """one sample step for all lanes; window [S, K+1] newest
        first, qlp [S, K]; returns (window, qlp, value [S])"""
        prev = window[:, 0]
        base = xp.take_along_axis(window, base_idx, axis=1)[:, 0]
        diffs = window[:, :K] - base[:, None]
        # products in f64: int32 diffs * int16-range qlp can exceed
        # int32; each f64 product (< 2^45) and the 32-term sum
        # (< 2^47) stay exact in f64
        lpc_sum = xp.sum(diffs.astype(xp.float64) *
                         qlp.astype(xp.float64) *
                         tap_live.astype(xp.float64), axis=1)
        outval = xp.floor(
            (half.astype(xp.float64) + lpc_sum) * qf_scale)
        main_val = _trunc_bits(
            xp,
            (outval + res_i.astype(xp.float64) +
             base.astype(xp.float64)).astype(xp.int64).astype(
                 xp.int32),
            nmask, sbit)

        # coefficient adaptation walk — masked unroll of the C
        # decoder's two mirror-image early-termination loops; lanes
        # deactivate as their running residual crosses zero, and
        # inactive lanes write their own current value back (no-op)
        residual = res_i.astype(xp.int32)
        s0 = xp.sign(residual).astype(xp.int32)
        new_qlp = qlp
        walk_vals = xp.take_along_axis(window, adapt_idx, axis=1)
        main_phase = i >= ord_eff + 1
        for t in range(max_order):
            active = ((residual * s0 > 0) & walk_live[:, t] &
                      main_phase)
            val = base - walk_vals[:, t]   # buf[0] - buf[order - pn]
            sgn = s0 * xp.sign(val).astype(xp.int32)
            pn_col = xp.clip(ordv - 1 - t, 0, K - 1)
            cur = xp.take_along_axis(new_qlp, pn_col[:, None],
                                     axis=1)[:, 0]
            col_val = xp.where(active, cur - sgn, cur)
            if xp is np:
                new_qlp = new_qlp.copy()
                new_qlp[np.arange(S), pn_col] = col_val
            else:
                new_qlp = new_qlp.at[xp.arange(S), pn_col].set(col_val)
            delta = ((val * sgn) >> shiftv) * mult[:, t]
            residual = xp.where(active, residual - delta, residual)

        # phase select: i == 0 passthrough; 1 <= i <= order diff
        # chain; else predictor output
        diff_val = _trunc_bits(xp, prev + res_i, nmask, sbit)
        val_out = xp.where(
            i == 0, res_i,
            xp.where(i <= ord_eff, diff_val, main_val)).astype(
                xp.int32)
        window = xp.concatenate([val_out[:, None], window[:, :K]],
                                axis=1)
        return (window, new_qlp, val_out)

    if xp is np:
        window = np.zeros((S, K + 1), dtype=np.int32)
        qlp = np.array(qlp0, dtype=np.int32, copy=True)
        out = np.empty((S, n), dtype=np.int32)
        for i in range(n):
            ii = np.full(S, i, dtype=np.int32)
            (window, qlp, val) = one(window, qlp, residuals[:, i], ii)
            out[:, i] = val
        return out

    import jax
    import jax.numpy as jnp

    U = 4
    while n % U:
        U //= 2

    def step(carry, xs):
        (window, qlp) = carry
        (res_u, i_u) = xs
        outs = []
        for u in range(U):
            ii = jnp.full((S,), i_u[u], dtype=jnp.int32)
            (window, qlp, val) = one(window, qlp, res_u[u], ii)
            outs.append(val)
        return ((window, qlp), jnp.stack(outs))

    window0 = jnp.zeros((S, K + 1), dtype=jnp.int32)
    xs = (residuals.T.reshape(n // U, U, S),
          jnp.arange(n, dtype=jnp.int32).reshape(n // U, U))
    ((_w, _q), ys) = jax.lax.scan(
        step, (window0, qlp0.astype(jnp.int32)), xs)
    return ys.reshape(n, S).T


def decorrelate(xp, ch0, ch1, lweight, ishift):
    """undoes the interlaced-stereo correlation for channel pairs

    ch0/ch1: int32 [G, n]; lweight/ishift: int32 [G] (lweight 0 =
    uncorrelated pair, pass through).  Returns (left, right)."""
    lw = lweight.astype(xp.int64)[:, None]
    shift = ishift.astype(xp.int64)[:, None]
    c0 = ch0.astype(xp.int64)
    c1 = ch1.astype(xp.int64)
    right = c0 - ((c1 * lw) >> shift)
    left = c1 + right
    live = (lweight != 0)[:, None]
    return (xp.where(live, left, c0).astype(xp.int32),
            xp.where(live, right, c1).astype(xp.int32))


def merge_lsbs(xp, samples, lsbs, lsb_bits):
    """re-attaches uncompressed LSB bytes after decorrelation

    samples: int32 [G, n]; lsbs: int32 [G, n] (zero where none);
    lsb_bits: int32 [G] (0 = no LSB bypass)"""
    ls = lsb_bits.astype(xp.int64)[:, None]
    merged = (samples.astype(xp.int64) << ls) | lsbs.astype(xp.int64)
    return merged.astype(xp.int32)
