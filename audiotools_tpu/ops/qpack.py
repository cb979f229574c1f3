"""Quantized-analysis upload transform (the encode path's wire format).

The FLAC/ALAC analysis kernels only *steer* encoding decisions — the
C++ emitters re-derive residuals exactly from the original host-side
PCM (``_native/hostkernels.cpp`` ``atpu_flac_emit_frames2``), so any
decision array yields a lossless stream.  That freedom lets the
host→device transfer (raw int16 uploads move 2 bytes per sample)
carry a *reduced-precision* view of the samples:

* **t (quantization spec)** — per (block, channel), analysis runs on
  ``(x >> t) << t``.  ``t`` is chosen from the mean second-difference
  magnitude so the quantization step stays ``2**guard``-fold below the
  residual scale: LPC coefficient and Rice parameter selection are
  perturbed far below their decision thresholds (quantization noise
  only *inflates* residual-magnitude sums, so Rice parameters never
  systematically shrink — oversized unary tails cannot happen).
* **exactness sideband** — two per-(block, variant) values the
  decisions must get exactly right for losslessness: the OR of all
  samples (wasted-bits; an overestimated shift would destroy
  low bits) and the is-constant flag (a false CONSTANT would drop the
  block).  Both are computed on host from the exact samples and fed to
  ``flac_frames.analyze_frames_packed``.
* **wire format** — first-differences of the quantized samples,
  zigzag-mapped and bit-packed to the batch-wide maximum width ``k``
  into uint32 lanes: typically 5–9 bits/sample instead of 16, a
  2–3x cut in host->device bytes.  The device reconstructs
  ``(x >> t) << t`` exactly with integer gathers + cumsum, so numpy
  and every JAX backend see bit-identical analysis inputs.

The *spec* is only "analysis input = ``(x >> t) << t`` with exact
or/const sideband"; the bit-packing is pure transport.  The scalar
oracle (``ref/flac_enc.py``) applies the same quantization directly,
which keeps oracle and device paths byte-identical by construction.

Reference counterpart: none — the reference's C encoder
(``/root/reference/src/encoders/flac.c:43``) reads PCM from host
memory and has no device transfer to feed; this module exists because
the device design treats host↔device bytes as a scarce resource.
"""

from __future__ import annotations

import os

import numpy as np

_DEFAULT_GUARD = 0


def enabled():
    """whether the quantized-upload spec is active (default on)"""
    return os.environ.get("ATPU_FLAC_QPACK", "1") != "0"


def alac_enabled():
    """the ALAC analysis' quantized-upload gate (default on; the
    scalar half of the spec lives in ref/alac.py qpack_enabled)"""
    return os.environ.get("ATPU_ALAC_QPACK", "1") != "0"


def guard_bits():
    """how many bits below the residual scale the quantization step
    sits; larger = closer-to-exact analysis, smaller = fewer wire bits"""
    return int(os.environ.get("ATPU_QPACK_GUARD", str(_DEFAULT_GUARD)))


_DEFAULT_CAP_MARGIN = 6


def cap_margin():
    """minimum significant bits the analysis always keeps: the
    quantization shift t is capped at bps - cap_margin.  Smaller
    margins send fewer wire bits but analyze coarser samples; the
    guard term already bounds decision perturbation, so the cap only
    matters for material whose residual scale approaches full scale"""
    return int(os.environ.get("ATPU_QPACK_CAP",
                              str(_DEFAULT_CAP_MARGIN)))


_DEFAULT_NOISE_EXTRA = 2


def noise_extra():
    """extra quantization shift for noise-dominated blocks (0 = off)

    Blocks whose mean |second difference| is >= 1.6x the mean
    |first difference| are noise-dominated: white noise gives
    sqrt(3) ~= 1.73 and high-frequency tones approach 2 sin(pi f/fs)
    (>= 1.6 above ~12 kHz), while program-material mixtures sit at
    or below ~1.5.  Such blocks add noise_extra bits to t with the
    cap released by 2 — typically HALVING the wire width on noise
    program material.  The 1.6 threshold matters: at 1.25 the bench
    tone+noise mix (d2/d1 ~1.4) classified as noise and its coarse
    step buried the tones' LPC fit in quantization noise (+2.8%
    coded size; the entropy stage is exact either way — it is the
    PREDICTOR fit that degrades).  At 1.6 only genuine noise and HF
    content coarsen; HF tonal frames whose fit does collapse are
    caught by the quantization-floor retry and re-analyze exactly
    (corpus sweeps measure -11.2% vs the reference fixtures with
    this default, vs -9.9% with the coarsening off)."""
    return int(os.environ.get("ATPU_QPACK_NOISE_EXTRA",
                              str(_DEFAULT_NOISE_EXTRA)))


def plan_t(blocks, bps, guard=None, margin=None, extra=None):
    """chooses the per-(block, channel) quantization shift t

    blocks: int32 [B, n, ch] exact samples
    returns t int32 [B, ch]

    spec (pure integer, any-backend deterministic):
      sum1 = sum_{i=1..n-1} |x[i] - x[i-1]|               (exact int64)
      sum2 = sum_{i=2..n-1} |x[i] - 2*x[i-1] + x[i-2]|    (exact int64)
      m    = sum2 // (n - 2)                  (0 when n <= 2)
      s    = max(0, bps - 26)   (static; keeps the cross-multiply
             below 2^63: sum2 < 2^(bps+18), so 5*(sum2>>s)*(n-1) <
             2^63 for every admitted bps; s == 0 for all bps <= 26,
             i.e. every real 16/24-bit stream incl. side channels)
      noise = (m > 0) and 5*(sum2>>s)*(n-1) >= 8*(sum1>>s)*(n-2)
      e     = noise_extra() if noise else 0
      marg  = max(cap_margin() - 2, 0) if (noise and e) else
              cap_margin()
      t    = clamp(bit_length(m) - 1 - guard + e, 0,
                   max(bps - marg, 0))

    The mean |second difference| tracks the coding-residual scale
    (it is the order-2 fixed predictor's mean error); keeping the
    step 2**guard below it bounds decision perturbation.  Constant
    blocks have sum2 == 0 and stay exact (t = 0).  The noise test
    (mean |d2| >= 1.6x mean |d1|) detects noise-dominated blocks —
    see noise_extra() for why those coarsen further."""
    if guard is None:
        guard = guard_bits()
    if margin is None:
        margin = cap_margin()
    if extra is None:
        extra = noise_extra()
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    if n <= 2:
        return np.zeros((B, ch), dtype=np.int32)
    x = blocks.astype(np.int64)
    d1 = np.abs(x[:, 1:, :] - x[:, :-1, :])
    sum1 = d1.sum(axis=1)                                  # [B, ch]
    d2 = np.abs(x[:, 2:, :] - 2 * x[:, 1:-1, :] + x[:, :-2, :])
    sum2 = d2.sum(axis=1)                                  # [B, ch]
    m = sum2 // (n - 2)
    s = max(0, int(bps) - 26)
    noise = (m > 0) & (5 * (sum2 >> s) * (n - 1) >=
                       8 * (sum1 >> s) * (n - 2))
    if extra <= 0:
        noise = np.zeros_like(noise)
    # bit_length via log-free integer loop (m < 2^33)
    bl = np.zeros_like(m)
    mm = m.copy()
    for _ in range(34):
        live = mm > 0
        if not live.any():
            break
        bl += live
        mm >>= 1
    cap = np.where(noise,
                   max(int(bps) - max(int(margin) - 2, 0), 0),
                   max(int(bps) - int(margin), 0))
    t = bl - 1 - guard + np.where(noise, int(extra), 0)
    return np.clip(t, 0, cap).astype(np.int32)


def quantize(xp, blocks, t):
    """the spec'd analysis input: (x >> t) << t, per (block, channel)

    blocks: int [B, n, ch]; t: int32 [B, ch]; returns int32 [B, n, ch]"""
    x = blocks.astype(xp.int32)
    tt = t[:, None, :]
    return (x >> tt) << tt


def variant_sideband(blocks, stereo_trial):
    """exact per-(block, variant) OR-of-samples and is-constant flags

    blocks: int [B, n, ch] exact samples; variant order matches
    ``flac_frames.build_variants`` ([L, R, mid, side] under stereo
    trials, else the channels themselves).

    returns (or_vals int32 [B, V], const_flags bool [B, V])"""
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    if stereo_trial:
        left = blocks[:, :, 0].astype(np.int32)
        right = blocks[:, :, 1].astype(np.int32)
        variants = [left, right, (left + right) >> 1, left - right]
    else:
        variants = [blocks[:, :, c].astype(np.int32) for c in range(ch)]
    or_vals = np.stack(
        [np.bitwise_or.reduce(v, axis=1) for v in variants], axis=1)
    const_flags = np.stack(
        [(v == v[:, :1]).all(axis=1) for v in variants], axis=1)
    return (or_vals.astype(np.int32), const_flags)


# the wire width k keys the jitted device unpack's compiled shape
# (W = ceil((n-1)*k/32) + 1), and raw k jitters with content between
# batches — each distinct value would cost a fresh XLA compile.
# Rounding k up to this coarse grid
# bounds the number of compiled programs at a few padding bits' wire
# cost.  31 is a hard ceiling: values straddle at most two uint32
# words and the unpack masks with a uint32 (1 << k) - 1, so k >= 32
# would silently corrupt the wire (callers disable qpack for streams
# whose zigzag diffs could need more).
K_GRID = (2, 3, 4, 6, 8, 10, 12, 16, 21, 26, 31)

# exception-capacity grid for the patched-base wire (see
# pack_patched): per-(block, channel) slots, each 2 uint32 columns
E_GRID = (8, 32, 128)


def round_k(k):
    """rounds the raw wire width up to the static K_GRID

    raises ValueError past 31 bits (the two-word wire format's hard
    limit) instead of producing corrupt packed words"""
    if k > 31:
        raise ValueError(
            "qpack wire width k=%d exceeds the 31-bit two-word "
            "format limit (disable qpack for this stream)" % (k,))
    for g in K_GRID:
        if k <= g:
            return g
    raise AssertionError("unreachable: K_GRID covers 1..31")


def pack(blocks, t):
    """bit-packs first-differences of the quantized samples (numpy
    reference implementation of the wire format; `_native.flac_qpack`
    is the production path and must produce identical words)

    blocks: int [B, n, ch]; t: int32 [B, ch]
    returns (packed uint32 [B, ch, W], k, x0 int32 [B, ch]) where
    x0 carries the exact first sample and W = ceil((n-1)*k/32) + 1
    (one pad word so two-word unpack gathers never index past the
    end)."""
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    xq = blocks.astype(np.int32) >> t[:, None, :]
    x0 = blocks[:, 0, :].astype(np.int32)
    if n <= 1:
        return (np.zeros((B, ch, 1), dtype=np.uint32), 1, x0)
    d = (xq[:, 1:, :] - xq[:, :-1, :]).astype(np.int64)
    u = ((d << 1) ^ (d >> 63)).astype(np.uint64)           # zigzag
    k = max(int(u.max()).bit_length(), 1) if u.size else 1
    k = round_k(k)
    W = ((n - 1) * k + 31) // 32 + 1
    packed = np.zeros((B, ch, W), dtype=np.uint32)
    flat = np.moveaxis(u, 1, 2).reshape(B * ch, n - 1)     # [B*ch, n-1]
    pw = packed.reshape(B * ch, W)
    bit = np.arange(n - 1, dtype=np.int64) * k
    wi = (bit >> 5).astype(np.int64)
    off = (bit & 31).astype(np.uint64)
    lo = ((flat << off) & 0xFFFFFFFF).astype(np.uint32)
    hi = (flat >> (np.uint64(32) - off)).astype(np.uint32)
    hi = np.where(off == 0, 0, hi).astype(np.uint32)
    np.bitwise_or.at(pw, (slice(None), wi), lo)
    np.bitwise_or.at(pw, (slice(None), wi + 1), hi)
    return (packed, k, x0)


def pack_patched(blocks, t, k_base, E):
    """numpy reference of the PATCHED-BASE wire (`
    _native.flac_qpack_patched` is the production path and must
    produce identical words/exceptions): every diff packs at the
    narrow ``k_base`` (low bits only) and values needing more bits
    ride as at most ``E`` per-(block, channel) (position, full value)
    exceptions the device scatters back before the cumsum — exact
    reconstruction at ~k_base bits/sample instead of the
    distribution's max width.

    returns (packed uint32 [B, ch, W], exc_pos int32 [B, ch, E],
    exc_val uint32 [B, ch, E], max_exc).  max_exc > E means the
    pack is INVALID (exceptions truncated); callers retry with a
    larger E or the plain format.  Unused slots pad with (0, true u
    at position 0) — a duplicate exact scatter."""
    blocks = np.asarray(blocks)
    (B, n, ch) = blocks.shape
    if n <= 1:
        raise ValueError("patched wire requires n > 1")
    xq = blocks.astype(np.int32) >> t[:, None, :]
    d = (xq[:, 1:, :] - xq[:, :-1, :]).astype(np.int64)
    u = ((d << 1) ^ (d >> 63)).astype(np.uint64)
    flat = np.moveaxis(u, 1, 2).reshape(B * ch, n - 1)
    exc = flat >> k_base != 0                              # [B*ch, m]
    counts = exc.sum(axis=1).astype(np.int64)
    max_exc = int(counts.max()) if counts.size else 0
    exc_pos = np.zeros((B * ch, E), dtype=np.int32)
    exc_val = np.tile(flat[:, :1].astype(np.uint32), (1, E))
    for r in range(B * ch):
        idx = np.nonzero(exc[r])[0][:E]
        exc_pos[r, :len(idx)] = idx
        exc_val[r, :len(idx)] = flat[r, idx].astype(np.uint32)
    masked = np.where(exc, flat & ((1 << k_base) - 1), flat)
    packed = _pack_tokens(masked, k_base).reshape(B, ch, -1)
    return (packed,
            exc_pos.reshape(B, ch, E),
            exc_val.reshape(B, ch, E),
            max_exc)


def _pack_tokens(flat, k):
    """bit-packs token rows [R, m] (each < 2^k) at width k into
    uint32 lanes [R, W] with the standard one-pad-word layout"""
    (R, m) = flat.shape
    W = (m * k + 31) // 32 + 1
    packed = np.zeros((R, W), dtype=np.uint32)
    bit = np.arange(m, dtype=np.int64) * k
    wi = (bit >> 5).astype(np.int64)
    off = (bit & 31).astype(np.uint64)
    lo = ((flat << off) & 0xFFFFFFFF).astype(np.uint32)
    hi = (flat >> (np.uint64(32) - off)).astype(np.uint32)
    hi = np.where(off == 0, 0, hi).astype(np.uint32)
    np.bitwise_or.at(packed, (slice(None), wi), lo)
    np.bitwise_or.at(packed, (slice(None), wi + 1), hi)
    return packed


def unpack(xp, packed, k, t, x0, n, exc_pos=None, exc_val=None):
    """reconstructs the quantized analysis input from the wire format

    packed: uint32 [B, ch, W]; k: static int; t, x0: int32 [B, ch]
    exc_pos/exc_val: optional patched-base exceptions
    ([B, ch, E], see pack_patched) scattered over the unpacked
    tokens before the cumsum
    returns int32 [B, n, ch] == quantize(blocks, t), exactly, on any
    backend (integer gathers, shifts and cumsum only)."""
    (B, ch, W) = packed.shape
    x0q = (x0 >> t).astype(xp.int32)                       # [B, ch]
    if n <= 1:
        return (x0q[:, None, :] << t[:, None, :])[:, :n, :]
    bit = np.arange(n - 1, dtype=np.int64) * k
    wi = xp.asarray(bit >> 5, dtype=xp.int32)              # [n-1] static
    off = xp.asarray((bit & 31).astype(np.uint32))
    lo = packed[:, :, wi] >> off[None, None, :]
    hi_src = packed[:, :, wi + 1]
    # off == 0 would shift by 32 (undefined); split the shift so the
    # expression is well-defined and exact for every offset
    hi = (hi_src << (xp.uint32(31) - off[None, None, :])) << xp.uint32(1)
    u = (lo | hi) & xp.uint32((1 << k) - 1)                # [B, ch, n-1]
    ui = u.astype(xp.int32)
    if exc_pos is not None:
        # patched-base wire: scatter the full-width exceptions over
        # the masked tokens (pads re-set position 0 to its exact
        # value — a no-op by construction)
        ev = exc_val.astype(xp.int32)
        if xp is np:
            (B_, ch_, E_) = exc_pos.shape
            bi = np.arange(B_)[:, None, None]
            ci = np.arange(ch_)[None, :, None]
            ui = ui.copy()
            ui[bi, ci, exc_pos] = ev
        else:
            ui = ui.at[
                xp.arange(B)[:, None, None],
                xp.arange(ch)[None, :, None],
                exc_pos].set(ev)
    d = (ui >> 1) ^ -(ui & 1)                              # un-zigzag
    xq = x0q[:, :, None] + xp.cumsum(d, axis=2, dtype=xp.int32)
    full = xp.concatenate([x0q[:, :, None], xq], axis=2)   # [B, ch, n]
    return xp.swapaxes(full, 1, 2) << t[:, None, :]
