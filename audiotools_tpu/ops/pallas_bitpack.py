"""Device-side parallel FLAC residual bit-packing.

The one genuinely new algorithm the device encoder needs (SURVEY.md
§7 step 2a): the reference serializes Rice-coded residuals with a sequential
bit writer (``/root/reference/src/encoders/flac.c`` residual emit /
``src/bitstream.c``), an inherently serial carry chain.  This module
re-derives it as a *parallel* program:

1. **tokenize** — every bit-field of a residual partition block
   (the 6-bit method+porder header, the per-partition 4/5-bit Rice
   parameters, one Rice code per residual) becomes a token with a
   total bit length ``l`` (unary zeros + stop + remainder) of which
   only the trailing ``c = 1 + r`` bits are nonzero ("payload");
2. **prefix-sum** the lengths to place every token at an absolute bit
   offset (XLA scan — the unary zeros never materialize: the output
   buffer is zero and only payloads are written);
3. **scatter** each payload into one or two 32-bit words of the
   MSB-first output stream with an XLA scatter-add
   (``scatter_words_xla``).  Payload bit-ranges are disjoint by
   construction, so adding equals or-ing and no carries arise.

``pack_residual_blocks`` runs the program with numpy or XLA.
Byte-identity against the serial reference
(``ref/flac_enc.write_residual_block`` — itself held byte-identical to
the C++ emitter by the oracle suites) is enforced by
``tests/test_pallas_bitpack.py``.

The encoder reaches this module through ``ATPU_PALLAS=1``: device-side
emit needs exact PCM uploads, so it replaces the quantized-analysis
wire (see ops/qpack.py).
"""

from __future__ import annotations

import os

import numpy as np


def enabled():
    """whether the encoder packs residuals on the device (opt-in)"""
    return os.environ.get("ATPU_PALLAS", "0") == "1"


def words_needed(n, bps, max_parts):
    """a safe static output width (in u32 words) for one subframe's
    residual block: verbatim-scale residuals plus headers"""
    bits = 6 + max_parts * 5 + n * (bps + 8)
    return (bits + 31) // 32


def tokenize(xp, res, orders, porders, params, n, max_parts):
    """token model of a batch of residual partition blocks

    res:     int32/int64 [S, n] residuals aligned at absolute
             positions (warm-up entries below the order are zero and
             become zero-length tokens)
    orders:  int32 [S] predictor orders
    porders: int32 [S] chosen partition orders
    params:  int32 [S, max_parts] Rice parameters (entries past the
             partition count ignored)

    returns (ends int32 [S, T], payload uint32 [S, T], widths int32
    [S, T], total_bits int32 [S]) with T = 1 + max_parts + n; ends
    are exclusive bit offsets from the prefix sum; only the trailing
    ``widths`` bits of each token are nonzero and equal ``payload``.

    All arithmetic is 32-bit: payload widths are <= 31 bits (5-bit
    Rice parameters cap at 30) and block bit totals sit far below
    2^31, so int32/uint32 suffice.

    Stream layout per subframe (matching the serial writers):
    ``[method(2) porder(4)] ([param(4|5)] [rice codes...]) * parts``
    with unused param slots as zero-length fillers at the end."""
    S = res.shape[0]
    T = 1 + max_parts + n

    res = res.astype(xp.int32)
    # zigzag mod 2^32 (exact: FLAC residuals fit int32)
    u = ((res << 1) ^ (res >> 31)).astype(xp.uint32)

    parts = (xp.ones(S, dtype=xp.int32) << porders)
    psize = (xp.full(S, n, dtype=xp.int32) >> porders)

    # coding method 1 when any USED partition's parameter exceeds 14
    pidx = xp.arange(max_parts, dtype=xp.int32)
    used = pidx[None, :] < parts[:, None]
    method = xp.any(xp.where(used, params, 0) > 14,
                    axis=1).astype(xp.int32)
    plen = xp.where(method == 1, 5, 4)                     # [S]

    # token index decomposition: g = j - 1; group p = g // (psize+1);
    # within == 0 -> param token, else residual p*psize + within-1
    j = xp.arange(T, dtype=xp.int32)                       # [T]
    g = xp.maximum(j - 1, 0)
    group = g[None, :] // (psize + 1)[:, None]             # [S, T]
    within = g[None, :] % (psize + 1)[:, None]
    is_header = (j == 0)[None, :] & xp.ones((S, 1), dtype=bool)
    live = group < parts[:, None]
    is_param = (~is_header) & live & (within == 0)
    res_pos = xp.clip(group * psize[:, None] + within - 1, 0, n - 1)
    is_res = (~is_header) & live & (within > 0)

    r = xp.take_along_axis(
        params, xp.clip(group, 0, max_parts - 1), axis=1)  # [S, T]
    r = r.astype(xp.int32)
    uj = xp.take_along_axis(u, res_pos.astype(xp.int32), axis=1)
    warmup = is_res & (res_pos < orders[:, None])

    header_val = ((method << 4) | porders).astype(xp.uint32)

    stop = xp.uint32(1) << r.astype(xp.uint32)             # r <= 30
    res_payload = stop | (uj & (stop - xp.uint32(1)))
    res_len = ((uj >> r.astype(xp.uint32)).astype(xp.int32)
               + 1 + r)
    res_width = (1 + r).astype(xp.int32)

    lengths = xp.where(
        is_header, 6,
        xp.where(is_param, plen[:, None],
                 xp.where(warmup, 0,
                          xp.where(is_res, res_len, 0)))).astype(
                              xp.int32)
    payload = xp.where(
        is_header, header_val[:, None],
        xp.where(is_param, r.astype(xp.uint32),
                 xp.where(warmup, xp.uint32(0),
                          xp.where(is_res, res_payload,
                                   xp.uint32(0)))))
    widths = xp.where(
        is_header, 6,
        xp.where(is_param, plen[:, None],
                 xp.where(warmup, 0,
                          xp.where(is_res, res_width, 0)))).astype(
                              xp.int32)

    ends = xp.cumsum(lengths, axis=1).astype(xp.int32)
    total_bits = ends[:, -1]
    return (ends, payload, widths, total_bits)


def split_contributions(xp, ends, payload, widths):
    """splits tokens into per-word contributions

    Token payloads occupy stream bits [e - c, e), MSB-first; each
    payload lands in word q1 = (e - 1) >> 5 and (when straddling)
    q0 = q1 - 1.  Returns (idx int32 [S, 2T], val uint32 [S, 2T])
    word contributions; zero-width tokens produce zero contributions
    at a harmless index.  32-bit-safe: widths c <= 31, so every
    shift amount stays in [0, 31]."""
    e = ends                                               # int32
    c = widths                                             # int32
    q1 = xp.maximum((e - 1) >> 5, 0).astype(xp.int32)
    lo_bits = xp.clip(e - (q1 << 5), 0, 32)                # in [1, 32]
    take = xp.minimum(lo_bits, c).astype(xp.uint32)        # <= 31
    mask = (xp.uint32(1) << take) - xp.uint32(1)
    lo_val = (payload & mask) << (32 - lo_bits).astype(xp.uint32)
    hi_val = xp.where(c > take.astype(xp.int32),
                      payload >> take, xp.uint32(0))
    q0 = xp.maximum(q1 - 1, 0)
    dead = (c == 0)
    lo_val = xp.where(dead, xp.uint32(0), lo_val)
    idx = xp.concatenate([q1, q0], axis=1)
    val = xp.concatenate([lo_val, hi_val], axis=1)
    return (idx, val)


def scatter_words_xla(xp, idx, val, n_words):
    """reference scatter: sum contributions into u32 words

    payload bit ranges are disjoint, so add == or (no carries).
    Works with numpy and jax (jnp .at[].add lowers to XLA
    scatter-add)."""
    S = idx.shape[0]
    out = xp.zeros((S, n_words), dtype=xp.uint32)
    if xp is np:
        rows = np.repeat(np.arange(S), idx.shape[1])
        np.add.at(out, (rows, idx.ravel()), val.ravel())
    else:
        rows = xp.repeat(xp.arange(S), idx.shape[1])
        out = out.at[rows, idx.ravel()].add(val.ravel())
    return out


def pack_residual_blocks(res, orders, porders, params, n_words,
                         backend=None):
    """packs a batch of residual partition blocks into u32 word lanes

    res: int [S, n] aligned residuals; orders/porders: int [S];
    params: int [S, max_parts]; returns (words uint32 [S, n_words],
    total_bits int32 [S]) — stream bit b lives in word b >> 5 at bit
    31 - (b & 31) (MSB-first).  backend: "numpy" | "xla"
    (default: "xla" if enabled() else "numpy")."""
    if backend is None:
        backend = "xla" if enabled() else "numpy"
    (S, n) = res.shape
    max_parts = params.shape[1]
    if backend == "numpy":
        (ends, payload, widths, total) = tokenize(
            np, np.asarray(res), np.asarray(orders),
            np.asarray(porders), np.asarray(params), n, max_parts)
        (idx, val) = split_contributions(np, ends, payload, widths)
        return (scatter_words_xla(np, idx, val, n_words),
                np.asarray(total))
    import jax.numpy as jnp
    (ends, payload, widths, total) = tokenize(
        jnp, jnp.asarray(res, dtype=jnp.int32),
        jnp.asarray(orders), jnp.asarray(porders),
        jnp.asarray(params), n, max_parts)
    (idx, val) = split_contributions(jnp, ends, payload, widths)
    return (scatter_words_xla(jnp, idx, val, n_words), total)


def residual_words_capacity(n, bps, max_parts):
    """output width (u32 words) per CHOSEN coded subframe

    A coded (FIXED/LPC) choice implies the whole subframe costs less
    than VERBATIM (flac_frames.analyze_subframes' choice chain), so
    its residual partition block is bounded by ~bps_subframe * n bits;
    bps + 2 covers the +1-bit side channel with a margin, plus the
    method/porder header and parameter fields."""
    bits = n * (bps + 2) + max_parts * 5 + 96
    return (bits + 31) // 32


def pack_chosen_residuals(xp, chosen, n, bps, stereo_trial, max_parts,
                          n_words):
    """packs the CHOSEN subframes' residual partition blocks on device

    chosen: the dict from analyze_frames_packed(return_chosen=True)
    returns (words uint32 [S, n_words], bits int32 [S], ok bool []):
    S = B * max_subframes rows in frame-major order (the emit splice's
    row layout).  Non-coded rows (CONSTANT/VERBATIM — emitted wholesale
    on host) contribute nothing and report 0 bits.  ``ok`` is False
    when any coded row overflows the capacity or its LPC analysis
    residuals touched the clip bound (ops/lpc.py lpc_residuals) — the
    caller must then fall back to exact host emit for the batch."""
    from . import flac_frames as ff

    res3 = chosen["residual"]                    # [B, M, n]
    B = res3.shape[0]
    M = res3.shape[1]
    S = B * M
    res = xp.reshape(res3, (S, n)).astype(xp.int32)
    orders = xp.reshape(chosen["order"], (S,)).astype(xp.int32)
    porders = xp.reshape(chosen["porder"], (S,)).astype(xp.int32)
    params = xp.reshape(chosen["rice_params"],
                        (S, max_parts)).astype(xp.int32)
    choice = xp.reshape(chosen["choice"], (S,))
    coded = ((choice == ff.CHOICE_FIXED) |
             (choice == ff.CHOICE_LPC))

    (ends, payload, widths, total) = tokenize(
        xp, res, orders, porders, params, n, max_parts)
    (idx, val) = split_contributions(xp, ends, payload, widths)
    # CONSTANT/VERBATIM rows may carry arbitrary analysis residuals;
    # zero their contributions so nothing scatters past capacity
    idx = xp.where(coded[:, None], idx, 0)
    val = xp.where(coded[:, None], val, xp.uint32(0))

    words = scatter_words_xla(xp, idx, val, n_words)

    # safety sideband: capacity + the LPC residual clip bound (a
    # clipped analysis residual is not the exact residual, so the
    # packed bits would be wrong — exact host emit handles the batch)
    max_bps = bps + 1 if stereo_trial else bps
    clip = xp.int32(1) << (max_bps + 4)          # < 2^31 for bps <= 25
    clipped = (choice == ff.CHOICE_LPC) & xp.any(
        xp.abs(res) >= clip, axis=1)
    row_ok = (~coded) | ((total <= 32 * n_words) & ~clipped)
    total = xp.where(coded, total, 0)
    return (words, total.astype(xp.int32), xp.all(row_ok))


def words_to_bytes(words, total_bits):
    """converts one subframe's u32 word lanes to the byte stream
    (zero-padded to a byte boundary), for comparison against serial
    bit writers"""
    data = np.asarray(words, dtype=">u4").tobytes()
    return data[:(int(total_bits) + 7) // 8]
