"""Device programs for the PCM converter / verification suite.

The three host converter kernels the north star names get env-gated
device backends here, each designed as batched array programs rather
than as ports of the reference's scalar loops:

* **Resampler FIR** (reference ``src/pcmconverter.c:360-466`` wrapping
  the vendored libsamplerate polyphase sinc, ``src/samplerate/
  src_sinc.c``): the per-output-sample tap loop becomes a batched
  window gather + coefficient gather with an f64 dot per
  output frame — one jitted program per (chunk, taps, channels) shape.
  Tolerance vs the host IEEE-f64 kernel: the device sums the taps in
  another order, so an integer output can differ by 1 LSB when its
  value sits within a few ulps of a rounding boundary.

* **ReplayGain equal-loudness filter** (reference
  ``src/replaygain.c:434,497,566-671``): the 10th-order Yulewalk +
  2nd-order Butterworth IIR cascade is a linear filter whose impulse
  response decays below f64 noise within a few thousand samples at
  every supported rate — so on device the sequential recurrence
  becomes a single causal FIR convolution with the truncated combined
  impulse response (an f32 conv at HIGHEST precision), followed by
  squaring and 50 ms window sums.  The reference's own statistic
  quantizes to 0.01 dB histogram bins, far above the truncation + f32
  conv noise.

* **AccurateRip V1/V2 MACs** (reference ``src/accuraterip.c:44-50``):
  offset-windowed multiply-accumulate CRCs in exact uint32 lattice
  arithmetic (16-bit digit products, explicit carry), bit-identical
  to the host kernel on every backend.

All programs are shape-static (inputs pad to a coarse grid) and
cache their jitted callables per shape.
"""

from __future__ import annotations

import os

import numpy as np

_jit_cache = {}


def resample_backend():
    """"jax" routes Resampler's FIR through the device program"""
    return os.environ.get("ATPU_RESAMPLE_BACKEND", "")


def rg_backend():
    """"jax" routes ReplayGain title analysis through the device FIR"""
    return os.environ.get("ATPU_RG_BACKEND", "")


def ar_backend():
    """"jax" routes AccurateRip checksums through the device MACs"""
    return os.environ.get("ATPU_AR_BACKEND", "")


def _pad_pow2(m, floor=1024):
    """rounds m up to a power of two >= floor (bounds jit recompiles)"""
    target = floor
    while target < m:
        target <<= 1
    return target


# ---------------------------------------------------------------------------
# Resampler FIR


def _resample_jit(M, taps, ch, L, D):
    """jitted windowed-sinc FIR evaluation (f64)

    out[i, c] = sum_t hist[starts[i] + t, c] * bank[q[i], t]
    """
    key = ("resample", M, taps, ch, L, D)
    if key not in _jit_cache:
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        def run(hist, starts, q, bank):
            # CHANNEL-MAJOR windows: hist transposes to [ch, L] so the
            # gathered window tensor is [ch, M, taps] with taps minor
            # (the [M, taps, ch] form puts ch = 2 in the minor dim)
            idx = starts[:, None] + jnp.arange(taps)[None, :]  # [M, t]
            hist_t = hist.T                       # [ch, L] f64
            win = hist_t[:, idx]                  # [ch, M, taps]
            coef = bank[q]                        # [M, taps] f64
            return jnp.sum(win * coef[None, :, :], axis=2).T  # [M, ch]

        _jit_cache[key] = jax.jit(run)
    return _jit_cache[key]


def resample_fir_device(hist, starts, q, bank):
    """device counterpart of ``_native.resample_fir``

    hist: f64 [L, ch]; starts: int [M]; q: int32 [M];
    bank: f64 [D, taps].  Returns f64 [M, ch].

    Shapes pad to a power-of-two grid (extra rows gather row 0 of the
    history with phase 0 and are dropped after the fetch)."""
    import jax

    (L, ch) = hist.shape
    (D, taps) = bank.shape
    M = len(starts)
    if M == 0:
        return np.zeros((0, ch), dtype=np.float64)
    # slab the output rows: the [ch, M_slab, taps] window tensor is
    # the program's footprint (f64), so 16384-row slabs
    # keep it ~128 MB regardless of the caller's chunk size
    SLAB = 16384
    Lp = _pad_pow2(L + taps)
    hist_p = np.zeros((Lp, ch), dtype=np.float64)
    hist_p[:L] = hist
    pieces = []
    for s0 in range(0, M, SLAB):
        sl = slice(s0, min(s0 + SLAB, M))
        m = sl.stop - sl.start
        Mp = _pad_pow2(m)
        starts_p = np.zeros(Mp, dtype=np.int32)
        starts_p[:m] = starts[sl]
        q_p = np.zeros(Mp, dtype=np.int32)
        q_p[:m] = q[sl]
        fn = _resample_jit(Mp, taps, ch, Lp, D)
        out = np.asarray(jax.device_get(
            fn(hist_p, starts_p, q_p, bank)))
        pieces.append(out[:m])
    return (np.concatenate(pieces, axis=0) if len(pieces) > 1
            else pieces[0])


# ---------------------------------------------------------------------------
# ReplayGain equal-loudness analysis


_fir_cache = {}

# impulse-response tail threshold: truncating where the combined
# response falls below this keeps the windowed-RMS relative error
# orders of magnitude under the 0.01 dB histogram bin
_H_TOL = 1e-13


def rg_combined_fir(sample_rate):
    """the combined Yulewalk+Butterworth impulse response, truncated
    where |h| stays below _H_TOL * max|h| forever after (computed once
    per rate with the host IIR kernel — the exact filter the device
    path replaces)"""
    if sample_rate not in _fir_cache:
        from .replaygain_coeffs import YULE, BUTTER
        from ..replaygain import _lfilter
        (yb, ya) = YULE[sample_rate]
        (bb, ba) = BUTTER[sample_rate]
        n = 1 << 15
        impulse = np.zeros(n, dtype=np.float64)
        impulse[0] = 1.0
        (step1, _z) = _lfilter(np.asarray(yb), np.asarray(ya), impulse,
                               np.zeros(10))
        (h, _z) = _lfilter(np.asarray(bb), np.asarray(ba), step1,
                           np.zeros(2))
        mag = np.abs(h)
        keep = np.nonzero(mag > _H_TOL * mag.max())[0]
        L = int(keep[-1]) + 1 if len(keep) else 1
        _fir_cache[sample_rate] = np.ascontiguousarray(h[:L])
    return _fir_cache[sample_rate]


def _rg_jit(n, L, win):
    """jitted filter+window program: causal FIR conv (f32), square,
    per-50ms-window sums; also the channel peak"""
    key = ("rg", n, L, win)
    if key not in _jit_cache:
        import jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp
        from jax import lax

        def run(x, h):
            # x: f32 [2, n] (both channels); h: f32 [L]
            xp_ = jnp.pad(x, [(0, 0), (L - 1, 0)])[:, None, :]
            kern = h[None, None, ::-1]
            # HIGHEST: a default-precision f32 conv may run in TF32
            y = lax.conv_general_dilated(
                xp_, kern, (1,), "VALID",
                precision=lax.Precision.HIGHEST)[:, 0, :]  # [2, n]
            sq = y[0] * y[0] + y[1] * y[1]               # [n]
            nwin = n // win
            # f64 window accumulation: keeps the one remaining f32
            # error source (the conv) well under the 0.01 dB bin
            sums = jnp.sum(
                jnp.reshape(sq[:nwin * win],
                            (nwin, win)).astype(jnp.float64), axis=1)
            return sums

        _jit_cache[key] = jax.jit(run)
    return _jit_cache[key]


def rg_window_sums(left, right, sample_rate, window_samples):
    """device ReplayGain analysis of one title's channels

    left/right: f64/float arrays scaled to the 16-bit domain (the
    reference's pre-filter scaling, replaygain.c:267); returns the
    per-50ms sums of the filtered squared mix, f64
    [n // window_samples].  The trailing partial window is dropped,
    matching the host path's per-title reset.  (Peaks stay host-side:
    they are defined over the ORIGINAL bps domain, not this scaled
    view.)"""
    import jax

    h = rg_combined_fir(sample_rate).astype(np.float32)
    n = len(left)
    nwin = n // window_samples
    if nwin == 0:
        return np.zeros(0)
    # pad to a power-of-two grid; padded samples are zeros and fall in
    # dropped windows (grid // window_samples >= nwin always)
    grid = _pad_pow2(n, floor=1 << 14)
    x = np.zeros((2, grid), dtype=np.float32)
    x[0, :n] = left
    x[1, :n] = right
    fn = _rg_jit(grid, len(h), window_samples)
    sums = jax.device_get(fn(x, h))
    return np.asarray(sums[:nwin], dtype=np.float64)


# ---------------------------------------------------------------------------
# AccurateRip device MACs


def _ar_jit(n):
    key = ("ar", n)
    if key not in _jit_cache:
        import jax
        import jax.numpy as jnp

        def run(values, indices, mask):
            # exact 32x32 -> 64 products in uint32 lattice arithmetic
            v = values.astype(jnp.uint32)
            ix = indices.astype(jnp.uint32)
            vl = v & jnp.uint32(0xFFFF)
            vh = v >> jnp.uint32(16)
            il = ix & jnp.uint32(0xFFFF)
            ih = ix >> jnp.uint32(16)
            ll = vl * il
            m1 = vh * il
            m2 = vl * ih
            mid = m1 + m2                 # may wrap uint32
            mid_carry = (mid < m1).astype(jnp.uint32)  # 1 if wrapped
            lo = ll + (mid << jnp.uint32(16))
            lo_carry = (lo < ll).astype(jnp.uint32)
            hi = (vh * ih + (mid >> jnp.uint32(16)) +
                  (mid_carry << jnp.uint32(16)) + lo_carry)
            m = mask.astype(jnp.uint32)
            lo = lo * m
            hi = hi * m
            # uint32 reduces wrap mod 2^32 (the checksum's own modulus)
            return (jnp.sum(lo, dtype=jnp.uint32),
                    jnp.sum(hi, dtype=jnp.uint32))

        _jit_cache[key] = jax.jit(run)
    return _jit_cache[key]


def accuraterip_update_device(samples, track_index, start_offset,
                              end_offset, v1, v2):
    """device AccurateRip V1/V2 update, bit-identical to
    ``_native.accuraterip_update``

    samples: int32 [n, 2] (16-bit range); returns (v1, v2) updated."""
    import jax

    n = samples.shape[0]
    if n == 0:
        return (v1, v2)
    npad = _pad_pow2(n, floor=1 << 14)
    left = samples[:, 0].astype(np.int64)
    right = samples[:, 1].astype(np.int64)
    values = (((right & 0xFFFF) << 16) |
              (left & 0xFFFF)).astype(np.uint32)
    indices = np.arange(track_index, track_index + n, dtype=np.int64)
    mask = ((indices >= start_offset) & (indices <= end_offset))
    values_p = np.zeros(npad, dtype=np.uint32)
    values_p[:n] = values
    indices_p = np.zeros(npad, dtype=np.uint32)
    indices_p[:n] = indices.astype(np.uint32)
    mask_p = np.zeros(npad, dtype=bool)
    mask_p[:n] = mask
    fn = _ar_jit(npad)
    (lo_sum, hi_sum) = jax.device_get(fn(values_p, indices_p, mask_p))
    v1 = (v1 + int(lo_sum)) & 0xFFFFFFFF
    v2 = (v2 + int(lo_sum) + int(hi_sum)) & 0xFFFFFFFF
    return (v1, v2)
