"""Batched Rice decoding — a vectorized bit-level state machine.

The batched re-expression of the reference decoder's bit-serial
Rice loop (``/root/reference/src/decoders/flac.c:1156-1193``): instead
of walking the bitstream one code at a time, each residual *partition*
(whose bit span and parameters the host scan recorded —
``_native.atpu_flac_scan``) is decoded as data-parallel array work
over u32 lanes:

1. the partition's bit window is expanded to a 0/1 bit matrix,
2. an exclusive prefix count + scatter builds ``ones_pos`` (position
   of the j-th set bit) so "next set bit at-or-after position p" is a
   single gather — the unary-quotient terminator lookup,
3. the per-position successor function ``next(p)`` (start of the code
   after one starting at ``p``) is composed by POINTER DOUBLING:
   log2(C) batched gathers yield the start positions of all C codes
   in a partition simultaneously — the sequential state machine
   becomes a parallel function composition,
4. quotient + low bits extract with two-word fetches and shifts, and
   zigzag decoding is branchless integer algebra.

Raw runs (escape partitions and VERBATIM subframes) use the same
machinery with a constant stride, skipping the terminator lookup.

Backend-generic: ``xp`` is numpy (host oracle / tests) or jax.numpy
inside jit (device path).  Both produce identical int32 residuals.
"""

from __future__ import annotations

import numpy as np


def _take1(xp, arr, idx):
    """take_along_axis over the last axis"""
    return xp.take_along_axis(arr, idx, axis=1)


def _bitcast_i32(xp, u):
    """reinterpret uint32 as int32 (no value conversion)"""
    if xp is np:
        return np.ascontiguousarray(u, dtype=np.uint32).view(np.int32)
    import jax.lax
    return jax.lax.bitcast_convert_type(
        u.astype(xp.uint32), xp.int32)


def _clz32(xp, v):
    """count leading zeros of uint32 (0 -> 32): bit smear + popcount"""
    y = v | (v >> xp.uint32(1))
    y = y | (y >> xp.uint32(2))
    y = y | (y >> xp.uint32(4))
    y = y | (y >> xp.uint32(8))
    y = y | (y >> xp.uint32(16))
    if xp is np:
        pc = np.bitwise_count(y.astype(np.uint32)).astype(np.int32)
    else:
        import jax.lax
        pc = jax.lax.population_count(y).astype(xp.int32)
    return 32 - pc


def _next_one_table(xp, bits, N):
    """next_one[p] = position of the first set bit at-or-after p
    (sentinel N-1 past the last set bit)

    a REVERSE RUNNING MINIMUM of masked positions — pure cumulative
    scans, with no cumsum + scatter + take construction"""
    pos = xp.arange(N, dtype=xp.int32)[None, :]
    masked = xp.where(bits == 1, pos, N - 1)
    if xp is np:
        return np.minimum.accumulate(
            masked[:, ::-1], axis=1)[:, ::-1].astype(np.int32)
    import jax.lax
    return jax.lax.cummin(masked, axis=1, reverse=True)


def decode_partitions(xp, words, word_base, base_bits, k, raw_bits,
                      count, W, C):
    """decodes a bucket of residual partitions from a shared bit buffer

    words:     [Wtot] uint32 — the frame bytes as big-endian 32-bit
               words (stream bit b lives at bit ``31 - b % 32`` of
               word ``b // 32``)
    word_base: [P] int32 — first word of each partition's window
    base_bits: [P] int32 — bit offset of the first code within the
               window (0..31)
    k:         [P] int32 — Rice parameter, or -1 for raw runs
    raw_bits:  [P] int32 — fixed code width for raw runs (escape
               partitions / VERBATIM), or -1 for Rice
    count:     [P] int32 — number of codes in the partition (<= C)
    W, C:      static bucket sizes: window words and max code count
               (the window must hold base_bits + the partition's bit
               length within W*32 bits)

    returns [P, C] int32 residuals (zigzag undone; raw runs
    sign-extended); positions >= count are 0
    """
    P = word_base.shape[0]
    N = W * 32
    Wtot = words.shape[0]

    # ---- window gather (one spare word for straddling reads) ----
    widx = word_base[:, None] + xp.arange(W + 1, dtype=xp.int32)[None, :]
    widx = xp.clip(widx, 0, Wtot - 1)
    win = words[widx]                                   # [P, W+1] u32

    is_raw = raw_bits >= 0
    kc = xp.maximum(k, 0).astype(xp.int32)
    rc = xp.maximum(raw_bits, 0).astype(xp.int32)

    pos = xp.arange(N, dtype=xp.int32)
    wi = (pos >> 5).astype(xp.int32)
    bi = (31 - (pos & 31)).astype(xp.uint32)
    bits = ((win[:, : W][:, wi] >> bi) & xp.uint32(1)).astype(
        xp.int32)                                       # [P, N]

    # ---- next-set-bit table ----
    next_one = _next_one_table(xp, bits, N)             # [P, N]

    # ---- successor function + pointer doubling ----
    nxt = xp.where(is_raw[:, None],
                   pos[None, :] + rc[:, None],
                   next_one + 1 + kc[:, None])
    A = xp.minimum(nxt, N - 1).astype(xp.int32)
    starts = base_bits[:, None].astype(xp.int32)        # [P, 1]
    m = 1
    while m < C:
        step = _take1(xp, A, xp.minimum(starts, N - 1))
        starts = xp.concatenate([starts, step], axis=1)
        m *= 2
        if m < C:
            A = _take1(xp, A, A)
    starts = starts[:, :C]

    # ---- code extraction ----
    st = xp.minimum(starts, N - 1)
    qpos = _take1(xp, next_one, st)                     # [P, C]
    q = (qpos - st).astype(xp.uint32)
    off = xp.where(is_raw[:, None], st, qpos + 1)
    nbits = xp.where(is_raw[:, None], rc[:, None],
                     kc[:, None]).astype(xp.int32)      # [P, C]

    wi2 = xp.minimum(off >> 5, W - 1).astype(xp.int32)
    w0 = _take1(xp, win, wi2)
    w1 = _take1(xp, win, wi2 + 1)
    sh = (off & 31).astype(xp.uint32)
    sh_safe = xp.maximum(sh, xp.uint32(1))
    hi = xp.where(sh == 0, w0,
                  (w0 << sh) | (w1 >> (xp.uint32(32) - sh_safe)))
    nb_safe = xp.clip(nbits, 1, 32).astype(xp.uint32)
    lsb = xp.where(nbits <= 0, xp.uint32(0),
                   hi >> (xp.uint32(32) - nb_safe))     # [P, C] u32

    # Rice: u = (q << k) | lsb, zigzag-undone
    u = ((q << kc[:, None].astype(xp.uint32)) | lsb).astype(xp.uint32)
    res_rice = _bitcast_i32(xp, (u >> xp.uint32(1)) ^
                            (xp.uint32(0) - (u & xp.uint32(1))))
    # raw: sign-extend nbits-wide value
    sbit = xp.where(nbits > 0,
                    xp.uint32(1) << (nb_safe - xp.uint32(1)),
                    xp.uint32(0))
    res_raw = _bitcast_i32(xp, (lsb ^ sbit) - sbit)

    res = xp.where(is_raw[:, None], res_raw, res_rice)
    valid = xp.arange(C, dtype=xp.int32)[None, :] < count[:, None]
    return xp.where(valid, res, 0).astype(xp.int32)


def decode_partitions_scan(xp, words, word_base, base_bits, k,
                           raw_bits, count, W, C):
    """decode_partitions for LARGE buckets: a lock-step scan over
    code indices

    Same contract as ``decode_partitions``.  Pointer doubling costs
    O(P * N * log C) general gathers, which for whole-subframe
    partitions (porder 0 at -8: N = 65536, C = 4096) is far more work
    than the codes themselves.  This path instead advances ALL P
    partitions one code per step (``lax.scan``): every step is a
    handful of [P]-wide row gathers.  All tables are WORD-level
    ([P, W] not [P, 32*W]): the next-set-bit lookup is a CLZ of the
    shifted current word with a next-nonzero-word table as the
    long-quotient fallback, so the memory footprint permits thousands
    of partition lanes per batch, which amortize each step's fixed
    cost.

    Backend-generic; the numpy path runs the identical algorithm
    step-by-step (oracle/tests)."""
    P = word_base.shape[0]
    N = W * 32
    Wtot = words.shape[0]

    widx = (word_base[:, None] +
            xp.arange(W + 1, dtype=xp.int32)[None, :])
    widx = xp.clip(widx, 0, Wtot - 1)
    win = words[widx]                                   # [P, W+1] u32

    is_raw = raw_bits >= 0
    kc = xp.maximum(k, 0).astype(xp.int32)
    rc = xp.maximum(raw_bits, 0).astype(xp.int32)

    # next-nonzero-word table: nzw[w] = smallest w' >= w with
    # win[w'] != 0, sentinel W (reverse running minimum — pure scans)
    widx_w = xp.arange(W, dtype=xp.int32)[None, :]
    masked_w = xp.where(win[:, :W] != xp.uint32(0), widx_w, W)
    if xp is np:
        nzw = np.minimum.accumulate(
            masked_w[:, ::-1], axis=1)[:, ::-1].astype(np.int32)
    else:
        import jax.lax
        nzw = jax.lax.cummin(masked_w.astype(xp.int32), axis=1,
                             reverse=True)

    ku = kc.astype(xp.uint32)

    def step(cur):
        """decodes one code at position `cur` for every partition;
        returns (residual [P] int32, next position [P] int32)"""
        st = xp.minimum(cur, N - 1)
        wi = (st >> 5).astype(xp.int32)
        bi = (st & 31).astype(xp.uint32)
        w_cur = _take1(xp, win, wi[:, None])[:, 0]
        rem = (w_cur << bi).astype(xp.uint32)
        # next set bit at-or-after st: within the current word via
        # CLZ, else the first set bit of the next nonzero word
        # (wi + 1 >= W falls off the window: sentinel W directly —
        # clamping into nzw would resurrect bits BEFORE st)
        wnext = xp.where(
            wi + 1 >= W, W,
            _take1(xp, nzw,
                   xp.minimum(wi + 1, W - 1)[:, None])[:, 0])
        w_far = _take1(xp, win,
                       xp.minimum(wnext, W)[:, None])[:, 0]
        t_in = st + _clz32(xp, rem)
        t_far = xp.where(wnext >= W, N - 1,
                         (wnext << 5) + _clz32(xp, w_far))
        qpos = xp.where(rem != 0, t_in,
                        t_far).astype(xp.int32)
        qpos = xp.minimum(qpos, N - 1)
        q = (qpos - st).astype(xp.uint32)
        off = xp.where(is_raw, st, qpos + 1)
        nbits = xp.where(is_raw, rc, kc)
        wi2 = xp.minimum(off >> 5, W - 1).astype(xp.int32)
        w0 = _take1(xp, win, wi2[:, None])[:, 0]
        w1 = _take1(xp, win, wi2[:, None] + 1)[:, 0]
        sh = (off & 31).astype(xp.uint32)
        sh_safe = xp.maximum(sh, xp.uint32(1))
        hi = xp.where(sh == 0, w0,
                      (w0 << sh) | (w1 >> (xp.uint32(32) - sh_safe)))
        nb_safe = xp.clip(nbits, 1, 32).astype(xp.uint32)
        lsb = xp.where(nbits <= 0, xp.uint32(0),
                       hi >> (xp.uint32(32) - nb_safe))
        u = ((q << ku) | lsb).astype(xp.uint32)
        res_rice = _bitcast_i32(xp, (u >> xp.uint32(1)) ^
                                (xp.uint32(0) - (u & xp.uint32(1))))
        sbit = xp.where(nbits > 0,
                        xp.uint32(1) << (nb_safe - xp.uint32(1)),
                        xp.uint32(0))
        res_raw = _bitcast_i32(xp, (lsb ^ sbit) - sbit)
        res = xp.where(is_raw, res_raw, res_rice)
        nxt = xp.where(is_raw, st + rc, qpos + 1 + kc)
        return (res.astype(xp.int32),
                xp.minimum(nxt, N - 1).astype(xp.int32))

    start = base_bits.astype(xp.int32)
    if xp is np:
        out = np.zeros((P, C), dtype=np.int32)
        cur = start
        for j in range(C):
            (res, cur) = step(cur)
            out[:, j] = res
    else:
        import jax.lax

        # U codes per scan step (identical arithmetic; C/U step
        # boundaries instead of C — step overhead is the wall)
        U = SCAN_UNROLL
        while C % U:
            U //= 2

        def body(cur, _):
            outs = []
            for _u in range(U):
                (res, cur) = step(cur)
                outs.append(res)
            return (cur, xp.stack(outs))

        (_cur, seq) = jax.lax.scan(body, start, None, length=C // U)
        out = seq.reshape(C, P).T                       # [P, C]

    valid = xp.arange(C, dtype=xp.int32)[None, :] < count[:, None]
    return xp.where(valid, out, 0).astype(xp.int32)


# code-count threshold above which the lock-step scan path decodes a
# bucket (below it, pointer doubling's log C gathers win)
SCAN_MIN_CODES = 256
# pointer doubling issues P * 32W * ceil(log2 C) general gathers;
# above this budget the lock-step scan (whose cost is per-STEP,
# nearly lane-width-independent) wins even for short partitions.
# Chunked decode batches put ~128k lanes in a (16..64, 64) bucket:
# pointer doubling there would issue ~400M gathers vs the scan's 16
# wide steps.
PD_GATHER_BUDGET = int(
    __import__("os").environ.get("ATPU_RICE_PD_BUDGET", str(1 << 24)))
# codes per lock-step scan step (see decode_partitions_scan): the
# step body unrolls U codes, so the scan pays C/U step boundaries
SCAN_UNROLL = int(
    __import__("os").environ.get("ATPU_RICE_SCAN_U", "16"))


def decode_partitions_auto(xp, words, word_base, base_bits, k,
                           raw_bits, count, W, C):
    """dispatches a bucket to pointer doubling or the lock-step scan
    (static shapes, so jit-safe)"""
    P = word_base.shape[0]
    logc = max(1, (C - 1).bit_length())
    if C >= SCAN_MIN_CODES or P * W * 32 * logc > PD_GATHER_BUDGET:
        return decode_partitions_scan(xp, words, word_base, base_bits,
                                      k, raw_bits, count, W, C)
    return decode_partitions(xp, words, word_base, base_bits, k,
                             raw_bits, count, W, C)


def scatter_residuals(xp, values, sub_idx, dest_off, count, S, n, C):
    """scatters bucket results [P, C] into subframe planes [S, n]

    values:  [P, C] int32 (zeros past count)
    sub_idx: [P] destination subframe row
    dest_off:[P] destination start position
    count:   [P] codes per partition
    """
    P = values.shape[0]
    cols = dest_off[:, None] + xp.arange(C, dtype=xp.int32)[None, :]
    if xp is np:
        out = np.zeros((S, n), dtype=np.int32)
        valid = np.arange(C, dtype=np.int32)[None, :] < count[:, None]
        rows = np.broadcast_to(sub_idx[:, None], (P, C))
        out[rows[valid], cols[valid]] = values[valid]
        return out
    # invalid positions scatter out of range and drop
    cols = xp.where(
        xp.arange(C, dtype=xp.int32)[None, :] < count[:, None],
        cols, n)
    rows = xp.broadcast_to(sub_idx[:, None], (P, C))
    out = xp.zeros((S, n), dtype=xp.int32)
    return out.at[rows, cols].set(values, mode="drop")


def bytes_to_words(data):
    """frame bytes -> big-endian uint32 words (host-side, numpy)"""
    buf = np.frombuffer(data, dtype=np.uint8)
    pad = (-len(buf)) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return buf.view(">u4").astype(np.uint32)
