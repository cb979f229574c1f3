"""WavPack decorrelation passes as batched device scans.

The batched re-expression of the reference WavPack encoder's
per-sample decorrelation loops (``/root/reference/src/encoders/
wavpack.c``, spec ``audiotools/py_encoders/wavpack.py:955-1136``,
oracle ``ref/wavpack.py correlation_pass_1ch/_2ch``):

Every pass computes ``r_i = x_i - ((w_i * src_i + 512) >> 10)`` where
the source series ``src`` depends ONLY on the pass *input* (terms
17/18: a 2-sample linear predictor of the input; terms 1-8: the input
delayed by the term; negative terms: the other channel's input) — so
``src`` vectorizes for the whole block, and the only true recurrence
is the sign-adaptive weight ``w_{i+1} = w_i ± delta``.  Each pass is
therefore ONE ``lax.scan`` carrying a scalar weight per lane; a
block's full pass chain (up to 16 passes) fuses into a single jitted
device program (the block-to-block state chain — quantized weights,
samples and entropies — is a format property and stays on host).

All arithmetic is exact int64 (x64), bit-identical to the oracle on
every backend.  ``xp`` is numpy (oracle cross-check) or jax.numpy.
"""

from __future__ import annotations

import numpy as np


def _apply_weight(w, s):
    return ((w * s) + 512) >> 10


def _update_weight(xp, source, result, delta):
    """0 if either is zero; +delta on matching signs, else -delta"""
    same_sign = (source ^ result) >= 0
    u = xp.where(same_sign, delta, -delta)
    return xp.where((source == 0) | (result == 0), 0, u)


def _scan(xp, f, state, xs_stacked, n):
    """lax.scan for jax; a python loop for the numpy oracle

    xs_stacked: tuple of [n, ...] arrays; f(state, xs_t) ->
    (state, y_t [L]); returns ys [n, L]"""
    if xp is np:
        ys = []
        for i in range(n):
            (state, y) = f(state, tuple(a[i] for a in xs_stacked))
            ys.append(y)
        return (state, np.stack(ys, axis=0))
    import jax
    return jax.lax.scan(f, state, xs_stacked)


def pass_positive(xp, x, term, delta, weights, samples):
    """terms 17/18 and 1-8: independent per-channel chains

    x: int64 [cc, n] pass input; weights: int64 [cc];
    samples: int64 [cc, S] stored warm-up (term 17/18: S=2 stored as
    [s0, s1] with the chain seeded [s1, s0]; terms 1-8: S=term)

    returns (out [cc, n], weights [cc], new_samples [cc, S])"""
    n = x.shape[1]
    if term in (17, 18):
        arr = xp.concatenate(
            [samples[:, 1:2], samples[:, 0:1], x], axis=1)
        if term == 18:
            src = (3 * arr[:, 1:-1] - arr[:, :-2]) >> 1
        else:
            src = 2 * arr[:, 1:-1] - arr[:, :-2]
    else:
        arr = xp.concatenate([samples, x], axis=1)
        src = arr[:, :n]

    def step(w, xs):
        (x_i, s_i) = xs
        r = x_i - _apply_weight(w, s_i)
        w = w + _update_weight(xp, s_i, r, delta)
        return (w, r)

    (w_out, ys) = _scan(xp, step, weights,
                        (xp.swapaxes(x, 0, 1),
                         xp.swapaxes(src, 0, 1)), n)
    out = xp.swapaxes(ys, 0, 1)
    if term in (17, 18):
        new_samples = xp.stack([out[:, n - 1], out[:, n - 2]], axis=1)
    else:
        new_samples = out[:, n - term:]
    return (out, w_out, new_samples)


def pass_negative(xp, x, term, delta, weights, samples):
    """terms -1/-2/-3: cross-channel chains with clamped weights

    x: int64 [2, n]; samples: int64 [2, 1] (channel 0's stored sample
    seeds channel 1's chain and vice versa); returns
    (out [2, n], weights [2]) — stored samples are unchanged by these
    terms (ref/wavpack.py correlation_pass_2ch)"""
    n = x.shape[1]
    # full0 = [s1] + x0 ; full1 = [s0] + x1
    full0 = xp.concatenate([samples[1, 0:1], x[0]])
    full1 = xp.concatenate([samples[0, 0:1], x[1]])
    if term == -1:
        src0 = full1[:n]            # full1[i - 1]
        src1 = full0[1:]            # full0[i]
    elif term == -2:
        src0 = full1[1:]            # full1[i]
        src1 = full0[:n]            # full0[i - 1]
    else:                           # term == -3
        src0 = full1[:n]            # full1[i - 1]
        src1 = full0[:n]            # full0[i - 1]

    def step(w, xs):
        (x0_i, x1_i, s0_i, s1_i) = xs
        (w0, w1) = w
        r0 = x0_i - _apply_weight(w0, s0_i)
        r1 = x1_i - _apply_weight(w1, s1_i)
        w0 = w0 + _update_weight(xp, s0_i, r0, delta)
        w1 = w1 + _update_weight(xp, s1_i, r1, delta)
        w0 = xp.clip(w0, -1024, 1024)
        w1 = xp.clip(w1, -1024, 1024)
        return ((w0, w1), xp.stack([r0, r1]))

    (w_out, ys) = _scan(xp, step, (weights[0], weights[1]),
                        (x[0], x[1], src0, src1), n)
    out = xp.swapaxes(ys, 0, 1)
    return (out, xp.stack([w_out[0], w_out[1]]))


# samples advanced per decode-scan step: the decode passes return no
# carry state, so the tail can zero-pad to a step multiple and the
# padded outputs simply drop — 16x fewer sequential scan steps (the
# per-step dispatch overhead is the decode wall, as with the FLAC
# synthesis scan's 16-sample unroll)
import os
_DEC_UNROLL = int(os.environ.get("ATPU_WV_DEC_UNROLL", "16"))


def dec_pass_positive(xp, x, term, delta, weights, samples):
    """DECODE direction for terms 17/18 and 1-8: the source series
    is the pass *output* (reference src/decoders/wavpack.c:2024,
    oracle ref/wavpack._decorrelation_pass_1ch), so the scan carries
    a ring of the last ``term`` (or 2) outputs alongside the weight.

    x: int64 [cc, n] correlated input; samples: int64 [cc, S] stored
    warm-up (terms 1-8: S=term, oldest first; 17/18: [s0, s1] with
    the chain seeded [s1, s0]); returns out [cc, n]"""
    n = x.shape[1]
    cc = x.shape[0]
    U = _DEC_UNROLL
    n_pad = -(-n // U) * U
    if n_pad != n:
        x = xp.concatenate(
            [x, xp.zeros((cc, n_pad - n), dtype=x.dtype)], axis=1)
    if term in (17, 18):
        # ring = [d[i], d[i+1]] (two most recent outputs)
        ring0 = xp.concatenate([samples[:, 1:2], samples[:, 0:1]],
                               axis=1)

        def substep(state, x_i):
            (w, ring) = state
            if term == 18:
                temp = (3 * ring[:, 1] - ring[:, 0]) >> 1
            else:
                temp = 2 * ring[:, 1] - ring[:, 0]
            out = _apply_weight(w, temp) + x_i
            w = w + _update_weight(xp, temp, x_i, delta)
            ring = xp.stack([ring[:, 1], out], axis=1)
            return ((w, ring), out)

        state0 = (weights, ring0)
    else:
        def substep(state, x_i):
            (w, ring) = state
            src = ring[:, 0]
            out = _apply_weight(w, src) + x_i
            w = w + _update_weight(xp, src, x_i, delta)
            ring = xp.concatenate([ring[:, 1:], out[:, None]],
                                  axis=1)
            return ((w, ring), out)

        state0 = (weights, samples)

    def step(state, xs):
        (xt,) = xs                       # [U, cc]
        outs = []
        for u in range(U):
            (state, out) = substep(state, xt[u])
            outs.append(out)
        return (state, xp.stack(outs, axis=0))

    xs = xp.swapaxes(x, 0, 1).reshape(n_pad // U, U, cc)
    (_state, ys) = _scan(xp, step, state0, (xs,), n_pad // U)
    out = ys.reshape(n_pad, cc)
    return xp.swapaxes(out, 0, 1)[:, :n]


def dec_pass_negative(xp, x, term, delta, weights, samples):
    """DECODE direction for terms -1/-2/-3: cross-channel recurrences
    on the *outputs* with clamped weights (oracle
    ref/wavpack._decorrelation_pass_2ch)

    x: int64 [2, n]; samples: int64 [2, 1]; returns out [2, n]"""
    n = x.shape[1]
    U = _DEC_UNROLL
    n_pad = -(-n // U) * U
    if n_pad != n:
        x = xp.concatenate(
            [x, xp.zeros((2, n_pad - n), dtype=x.dtype)], axis=1)

    def substep(state, x0_i, x1_i):
        (w0, w1, prev0, prev1) = state
        if term == -1:
            out0 = _apply_weight(w0, prev1) + x0_i
            out1 = _apply_weight(w1, out0) + x1_i
            w0 = w0 + _update_weight(xp, prev1, x0_i, delta)
            w1 = w1 + _update_weight(xp, out0, x1_i, delta)
        elif term == -2:
            out1 = _apply_weight(w1, prev0) + x1_i
            out0 = _apply_weight(w0, out1) + x0_i
            w1 = w1 + _update_weight(xp, prev0, x1_i, delta)
            w0 = w0 + _update_weight(xp, out1, x0_i, delta)
        else:                                   # term == -3
            out0 = _apply_weight(w0, prev1) + x0_i
            out1 = _apply_weight(w1, prev0) + x1_i
            w0 = w0 + _update_weight(xp, prev1, x0_i, delta)
            w1 = w1 + _update_weight(xp, prev0, x1_i, delta)
        w0 = xp.clip(w0, -1024, 1024)
        w1 = xp.clip(w1, -1024, 1024)
        return ((w0, w1, out0, out1), xp.stack([out0, out1]))

    def step(state, xs):
        (x0t, x1t) = xs                  # [U], [U]
        outs = []
        for u in range(U):
            (state, o) = substep(state, x0t[u], x1t[u])
            outs.append(o)
        return (state, xp.stack(outs, axis=0))   # [U, 2]

    # seeding swap per the oracle: channel 0's chain starts from
    # dec_samples[1][0], channel 1's from dec_samples[0][0]
    state0 = (weights[0], weights[1], samples[1, 0], samples[0, 0])
    (_state, ys) = _scan(xp, step, state0,
                         (x[0].reshape(n_pad // U, U),
                          x[1].reshape(n_pad // U, U)), n_pad // U)
    out = ys.reshape(n_pad, 2)
    return xp.swapaxes(out, 0, 1)[:, :n]


def run_dec_chain(xp, x, chain, weights, samples_list):
    """runs a block's full DECODE decorrelation chain (one jitted
    program per (chain, cc, n) — the decode mirror of
    run_pass_chain)

    x: int64 [cc, n] residuals; chain: static tuple of (term,
    delta); weights: int64 [P, cc]; samples_list: tuple of int64
    [cc, S_p]; returns decorrelated [cc, n]"""
    latest = x
    for (p, (term, delta)) in enumerate(chain):
        if term > 0:
            latest = dec_pass_positive(
                xp, latest, term, delta, weights[p], samples_list[p])
        else:
            latest = dec_pass_negative(
                xp, latest, term, delta, weights[p], samples_list[p])
    return latest


def run_pass_chain(xp, x, chain, weights, samples_list):
    """runs a block's full decorrelation chain

    x: int64 [cc, n]; chain: static tuple of (term, delta);
    weights: int64 [P, cc] per-pass weights; samples_list: tuple of
    int64 [cc, S_p] per-pass warm-up samples (S_p static per term).

    returns (correlated [cc, n], new_weights [P, cc],
    new_samples tuple) — one device program per (chain, cc, n)."""
    P = len(chain)
    new_weights = []
    new_samples = []
    latest = x
    for (p, (term, delta)) in enumerate(chain):
        if term > 0:
            (latest, w, s) = pass_positive(
                xp, latest, term, delta, weights[p], samples_list[p])
        else:
            (latest, w) = pass_negative(
                xp, latest, term, delta, weights[p], samples_list[p])
            s = samples_list[p]
        new_weights.append(w)
        new_samples.append(s)
    return (latest, xp.stack(new_weights, axis=0), tuple(new_samples))
