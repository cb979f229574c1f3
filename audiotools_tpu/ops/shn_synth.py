"""Batched Shorten decode synthesis: diff-predictor inversion as
k-fold cumulative sums plus closed-form warm-up terms.

The batched re-expression of the reference SHN decoder's
per-sample loops (``/root/reference/src/decoders/shn.c:1142``, spec
``audiotools/py_decoders/shn.py`` read_diff1-3, oracle
``ref/shn.py:425-446``): a DIFFk block satisfies ``D^k x = r`` (k-th
finite difference equals the residual stream), so its inverse is the
k-fold inclusive cumulative sum of the residuals plus an affine
function of the three warm-up samples:

  DIFF1: x[i] = w1 + C1[i]
  DIFF2: x[i] = w1 + (i+1)*(w1-w2) + C2[i]
  DIFF3: x[i] = w1 + (i+1)*a1 + T(i)*a2 + C3[i]
         a1 = w1-w2, a2 = w1-2*w2+w3, T(i) = (i+1)(i+2)/2

with Ck the k-fold cumsum of the residual row and w1/w2/w3 the last
three decoded (pre-shift) samples of the channel's previous block.
Every block therefore decodes INDEPENDENTLY (log-depth cumsums over
[rows, n] planes — no sequential scan at all); the host chains the
3-sample warm-up state across blocks from closed-form tail values
(``codecs/shn.py``), which the entropy scan's residuals determine
without running the device program.

DIFF0 (means-free) and ZERO rows are direct fills; QLPC and
DIFF0-with-means streams fall back to the host decoder (the scan
refuses them).

Intermediate magnitudes: C3 terms reach ~n^2 * |r| (~2^33 at
n = 1024, 16-bit), so sums run in int64 (exact; jax x64 enabled by
the caller) and only the final samples cast to int32.

Backend-generic: ``xp`` = numpy (oracle cross-check) or jax.numpy.
"""

from __future__ import annotations

import numpy as np

CMD_DIFF0 = 0
CMD_DIFF1 = 1
CMD_DIFF2 = 2
CMD_DIFF3 = 3
CMD_ZERO = 8


def synthesize(xp, res, cmd, warm, shift, sign_adjustment):
    """decodes [R, n] residual rows into [R, n] output samples

    res:   int32 [R, n] residuals (zero-padded past block length)
    cmd:   int32 [R] Shorten command (CMD_*)
    warm:  int64/int32 [R, 3] previous block's last three pre-shift
           samples, warm[:, 0] = x[-1]
    shift: int32 [R] left shift applied after prediction
    sign_adjustment: int (static) subtracted from shifted samples

    returns int32 [R, n] (columns past the row's block length are
    garbage; the caller trims)"""
    R, n = res.shape
    r64 = res.astype(xp.int64)
    c1 = xp.cumsum(r64, axis=1)
    c2 = xp.cumsum(c1, axis=1)
    c3 = xp.cumsum(c2, axis=1)
    i1 = xp.arange(1, n + 1, dtype=xp.int64)[None, :]     # i+1
    tri = (i1 * (i1 + 1)) // 2                            # T(i)
    w1 = warm[:, 0:1].astype(xp.int64)
    w2 = warm[:, 1:2].astype(xp.int64)
    w3 = warm[:, 2:3].astype(xp.int64)
    a1 = w1 - w2
    a2 = w1 - 2 * w2 + w3
    x1 = w1 + c1
    x2 = w1 + i1 * a1 + c2
    x3 = w1 + i1 * a1 + tri * a2 + c3
    cmd_c = cmd[:, None]
    x = xp.where(cmd_c == CMD_DIFF1, x1,
                 xp.where(cmd_c == CMD_DIFF2, x2,
                          xp.where(cmd_c == CMD_DIFF3, x3,
                                   xp.where(cmd_c == CMD_ZERO,
                                            xp.int64(0), r64))))
    v = (x << shift[:, None].astype(xp.int64)) - sign_adjustment
    return v.astype(xp.int32)


def warmup_chain(res, row_meta, channels):
    """host-side warm-up bookkeeping: [R, 3] per-row warm inputs

    For each row (in stream order) computes the previous same-channel
    block's last three PRE-SHIFT samples from closed-form tails —
    x[t] at t = n-1, n-2, n-3 via the module formulas — without
    materializing any decoded block.  Matches the reference decoder's
    history handling (short blocks keep earlier history samples:
    ref/shn.py wrapped_samples, hostkernels atpu_shn_decode)."""
    R = res.shape[0]
    warm = np.zeros((R, 3), dtype=np.int64)
    hist = [np.zeros(3, dtype=np.int64) for _ in range(channels)]
    r64 = res.astype(np.int64)
    c1 = np.cumsum(r64, axis=1)
    c2 = np.cumsum(c1, axis=1)
    c3 = np.cumsum(c2, axis=1)
    for row in range(R):
        (cmd, n, _shift, chan) = (int(row_meta[row, 0]),
                                  int(row_meta[row, 1]),
                                  int(row_meta[row, 2]),
                                  int(row_meta[row, 3]))
        h = hist[chan]
        warm[row] = h
        if n <= 0:
            continue
        (w1, w2, w3) = (int(h[0]), int(h[1]), int(h[2]))
        a1 = w1 - w2
        a2 = w1 - 2 * w2 + w3
        tails = []
        for t in range(max(n - 3, 0), n):
            i1 = t + 1
            if cmd == CMD_DIFF1:
                x = w1 + int(c1[row, t])
            elif cmd == CMD_DIFF2:
                x = w1 + i1 * a1 + int(c2[row, t])
            elif cmd == CMD_DIFF3:
                x = (w1 + i1 * a1 + (i1 * (i1 + 1) // 2) * a2 +
                     int(c3[row, t]))
            elif cmd == CMD_ZERO:
                x = 0
            else:                                  # DIFF0, no means
                x = int(r64[row, t])
            tails.append(x)
        # hist layout is [x[-1], x[-2], x[-3]] (newest first); a
        # short block pushes its samples and keeps older history in
        # the remaining slots (reference behavior for n < 3)
        newest_first = tails[::-1] + list(h)
        hist[chan] = np.array(newest_first[:3], dtype=np.int64)
    return warm
