"""Batched TTA decode synthesis: the hybrid filter and fixed
predictor inverted as ONE fused scan, decorrelation undone as vector
ops.

The batched re-expression of the reference TTA decoder's
per-sample loop (``/root/reference/src/decoders/tta.c:849``, spec
``audiotools/py_decoders/tta.py``, host kernel
``atpu_tta_decode_frame``): the byte-serial adaptive Rice layer stays
on host (``_native.tta_scan_residuals`` — its k0/k1 adaptation
depends only on the unsigned values, so residual extraction never
needs the filter); the remaining chain is

* inverse hybrid filter — the encoder scan's state machine
  (ops/tta_scan.hybrid_filter) with input/output roles swapped:
  ``predicted = residual + (dot >> fshift)``, state updates
  identical (wrapping int32, exact mod 2^32 like the encode side),
* inverse fixed predictor — ``x[i] = p[i] + prev + ((-prev) >> s)``
  with prev = x[i-1]: the identity ``((prev << s) - prev) >> s ==
  prev + ((-prev) >> s)`` keeps it in native int32 (no int64/f64),
  exact for every int32 prev,
* inverse channel decorrelation — per-sample algebra with no
  recurrence over time: it runs as plain vector ops after the scan.

Both recurrences fuse into a single ``lax.scan`` over sample
positions with every (frame, channel) lane advancing together.
Backend-generic: ``xp`` = numpy (oracle cross-check) or jax.numpy.
"""

from __future__ import annotations

import numpy as np

from . import tta_scan


def inverse_filter_predict(xp, residuals, bps):
    """[L, n] residual lanes -> [L, n] pre-decorrelation samples"""
    fshift = tta_scan.filter_shift_for(bps)
    shift = tta_scan.shift_for(bps)
    round_v = np.int32(1 << (fshift - 1))
    L = residuals.shape[0]
    n = residuals.shape[1]

    if xp is np:
        qm = np.zeros((L, 8), dtype=np.int32)
        dx = np.zeros((L, 8), dtype=np.int32)
        dl = np.zeros((L, 8), dtype=np.int32)
        prev_res = np.zeros(L, dtype=np.int32)
        prev_out = np.zeros(L, dtype=np.int32)
        out = np.empty((L, n), dtype=np.int32)
        with np.errstate(over="ignore"):
            for i in range(n):
                res = residuals[:, i]
                if i == 0:
                    p = res - (round_v >> fshift)
                else:
                    sign = np.sign(prev_res)[:, None].astype(np.int32)
                    qm = qm + sign * dx
                    acc = np.full(L, round_v, dtype=np.int32)
                    for j in range(8):
                        acc = acc + dl[:, j] * qm[:, j]
                    p = res + (acc >> fshift)
                prev_res = res
                (dx, dl) = tta_scan._shift_state(np, dx, dl, p)
                if i == 0:
                    x = p
                else:
                    x = p + (prev_out + ((-prev_out) >> shift))
                prev_out = x
                out[:, i] = x
        return out

    import jax
    import jax.numpy as jnp

    def step(state, res):
        (qm, dx, dl, prev_res, prev_out, first) = state
        sign = jnp.sign(prev_res)[:, None].astype(jnp.int32)
        qm2 = qm + sign * dx
        acc = jnp.full(L, round_v, dtype=jnp.int32) + jnp.sum(
            dl * qm2, axis=1, dtype=jnp.int32)
        p = jnp.where(first,
                      res - (round_v >> fshift),
                      res + (acc >> fshift))
        qm = jnp.where(first, qm, qm2)
        (dx, dl) = tta_scan._shift_state(jnp, dx, dl, p)
        x = jnp.where(first, p,
                      p + (prev_out + ((-prev_out) >> shift)))
        return ((qm, dx, dl, res, x,
                 jnp.zeros((), dtype=bool)), x)

    state0 = (jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros((L, 8), dtype=jnp.int32),
              jnp.zeros(L, dtype=jnp.int32),
              jnp.zeros(L, dtype=jnp.int32),
              jnp.ones((), dtype=bool))
    (_, ys) = jax.lax.scan(step, state0, residuals.T)
    return ys.T


def decorrelate_inverse(xp, samples):
    """undoes encoder channel decorrelation (per-sample algebra)

    samples: int32 [F, n, ch]; returns int32 [F, n, ch]"""
    ch = samples.shape[2]
    if ch == 1:
        return samples
    prev = samples[:, :, ch - 2]
    half = xp.sign(prev) * (xp.abs(prev) // 2)       # trunc halve
    last = samples[:, :, ch - 1] + half
    outs = [None] * ch
    outs[ch - 1] = last
    for c in range(ch - 2, -1, -1):
        outs[c] = outs[c + 1] - samples[:, :, c]
    return xp.stack(outs, axis=2)


def synthesize(xp, residuals, bps):
    """full TTA decode synthesis: [F, n, ch] residuals -> samples"""
    (F, n, ch) = residuals.shape
    lanes = xp.transpose(residuals, (0, 2, 1)).reshape(F * ch, n)
    x = inverse_filter_predict(xp, lanes, bps)
    x = xp.transpose(x.reshape(F, ch, n), (0, 2, 1))
    return decorrelate_inverse(xp, x)
