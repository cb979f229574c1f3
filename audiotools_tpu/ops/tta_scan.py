"""Batched TTA encode analysis: decorrelation + fixed predictor +
the hybrid adaptive filter as one fused scan.

The batched re-expression of the reference TTA encoder's per-sample
loop (``/root/reference/src/encoders/tta.c``, spec
``audiotools/py_encoders/tta.py:151-225``, oracle ``ref/tta.py``):
channel decorrelation and the fixed predictor are pure vector ops; the
sign-adaptive hybrid IIR (qm/dx/dl state with 32-bit wraparound) is a
true recurrence, so it runs as ONE ``lax.scan`` over sample positions
with every (frame, channel) lane advancing together — the same shape
as the FLAC/ALAC analysis programs.  The byte-serial tail (two-level
adaptive Rice + CRC-32) stays on host (``_native.atpu_tta_pack_frames``).

Exactness: the filter dot product is defined mod 2^32 (the reference
casts the int64 sum through uint32), and wrapping int32 adds/muls are
homomorphic mod 2^32 — so the whole filter runs in native int32 with
XLA's defined two's-complement wraparound, bit-identical to the oracle
on every backend.  The fixed predictor's ``(prev << shift) - prev``
can exceed int32 for 24-bit input, so it computes in exact f64
(products < 2^36) with an exact power-of-two floor-shift.

Backend-generic: ``xp`` = numpy (oracle cross-check) or jax.numpy.
"""

from __future__ import annotations

import numpy as np

from . import lpc as lpc_ops


def shift_for(bps):
    return {8: 4, 16: 5, 24: 5}[bps]


def filter_shift_for(bps):
    return {8: 10, 16: 9, 24: 10}[bps]


def correlate(xp, samples):
    """encoder channel decorrelation (ref/tta.py correlate_channels)

    samples: int32 [F, n, ch]; returns int32 [F, n, ch]"""
    ch = samples.shape[2]
    if ch == 1:
        return samples
    diffs = samples[:, :, 1:] - samples[:, :, :-1]     # [F, n, ch-1]
    prev = diffs[:, :, -1]
    half = xp.sign(prev) * (xp.abs(prev) // 2)         # trunc halve
    last = samples[:, :, -1] - half
    return xp.concatenate([diffs, last[:, :, None]], axis=2)


def fixed_predict(xp, correlated, bps):
    """the fixed predictor over the sample axis (vectorized)

    correlated: int32 [F, n, ch]; exact f64 internals (see module
    docstring); returns int32 [F, n, ch]"""
    shift = shift_for(bps)
    prev = correlated[:, :-1, :].astype(xp.float64)
    scale = float(lpc_ops.exact_exp2(np, -shift))
    # ((prev << s) - prev) >> s  ==  floor(prev * (2^s - 1) / 2^s)
    pred = xp.floor(prev * float((1 << shift) - 1) * scale)
    out = correlated.astype(xp.float64)
    head = out[:, :1, :]
    tail = out[:, 1:, :] - pred
    return xp.concatenate([head, tail], axis=1).astype(xp.int32)


def hybrid_filter(xp, predicted, bps):
    """the sign-adaptive hybrid IIR filter as a batched recurrence

    predicted: int32 [L, n] lanes (one per frame x channel);
    returns residuals int32 [L, n], bit-identical to ref/tta.py
    tta_filter"""
    fshift = filter_shift_for(bps)
    round_v = np.int32(1 << (fshift - 1))
    L = predicted.shape[0]
    n = predicted.shape[1]

    if xp is np:
        qm = np.zeros((L, 8), dtype=np.int32)
        dx = np.zeros((L, 8), dtype=np.int32)
        dl = np.zeros((L, 8), dtype=np.int32)
        prev_res = np.zeros(L, dtype=np.int32)
        out = np.empty((L, n), dtype=np.int32)
        with np.errstate(over="ignore"):
            for i in range(n):
                p = predicted[:, i]
                if i == 0:
                    res = p + (round_v >> fshift)
                else:
                    sign = np.sign(prev_res)[:, None].astype(np.int32)
                    qm = qm + sign * dx
                    acc = np.full(L, round_v, dtype=np.int32)
                    for j in range(8):
                        acc = acc + dl[:, j] * qm[:, j]
                    res = p - (acc >> fshift)
                out[:, i] = res
                prev_res = res
                (dx, dl) = _shift_state(np, dx, dl, p)
        return out

    import jax
    import jax.numpy as jnp

    def step(state, p):
        (qm, dx, dl, prev_res, first) = state
        sign = jnp.sign(prev_res)[:, None].astype(jnp.int32)
        qm2 = qm + sign * dx
        acc = jnp.full(L, round_v, dtype=jnp.int32) + jnp.sum(
            dl * qm2, axis=1, dtype=jnp.int32)
        res = jnp.where(first,
                        p + (round_v >> fshift),
                        p - (acc >> fshift))
        qm = jnp.where(first, qm, qm2)
        (dx, dl) = _shift_state(jnp, dx, dl, p)
        return ((qm, dx, dl, res, jnp.zeros((), dtype=bool)), res)

    state0 = (jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros(L, dtype=jnp.int32),
              jnp.ones((), dtype=bool))
    (_, ys) = jax.lax.scan(step, state0, predicted.T)
    return ys.T


def _shift_state(xp, dx, dl, p):
    """the dx/dl state rotation (ref/tta.py tta_filter tail)"""
    new_dx = xp.stack([
        dx[:, 1], dx[:, 2], dx[:, 3], dx[:, 4],
        xp.where(dl[:, 4] >= 0, 1, -1).astype(xp.int32),
        xp.where(dl[:, 5] >= 0, 2, -2).astype(xp.int32),
        xp.where(dl[:, 6] >= 0, 2, -2).astype(xp.int32),
        xp.where(dl[:, 7] >= 0, 4, -4).astype(xp.int32),
    ], axis=1)
    d7 = p - dl[:, 7]
    d6 = -dl[:, 6] + d7
    d5 = -dl[:, 5] + d6
    new_dl = xp.stack([dl[:, 1], dl[:, 2], dl[:, 3], dl[:, 4],
                       d5, d6, d7, p], axis=1)
    return (new_dx, new_dl)


def analyze_frames(xp, samples, bps):
    """the full TTA encode analysis for a batch of frames

    samples: int32 [F, n, ch] PCM (short final frames zero-padded —
    the filter is causal, so a prefix of the padded result equals the
    unpadded run); returns residuals int32 [F, n, ch]"""
    F = samples.shape[0]
    n = samples.shape[1]
    ch = samples.shape[2]
    correlated = correlate(xp, samples.astype(xp.int32))
    predicted = fixed_predict(xp, correlated, bps)
    lanes = xp.reshape(xp.swapaxes(predicted, 1, 2), (F * ch, n))
    res = hybrid_filter(xp, lanes, bps)
    return xp.swapaxes(xp.reshape(res, (F, ch, n)), 1, 2)
