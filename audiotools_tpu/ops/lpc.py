"""Batched LPC analysis primitives, deterministic across backends.

These functions define the framework's *numerical spec* for FLAC/ALAC
LPC analysis (window -> autocorrelation -> Levinson-Durbin ->
error-feedback quantization), re-deriving the reference algorithms
(``/root/reference/audiotools/py_encoders/flac.py:565-737``) as batched
array programs with bit-deterministic semantics.

**Contraction immunity.**  XLA may fuse a multiply feeding an add into
a fused multiply-add (one rounding instead of two) or evaluate fused
regions at excess precision — observed under SPMD partitioning on CPU
— so "IEEE mul then IEEE add" is NOT a portable spec, and
optimization barriers do not reliably survive partitioning.  Instead
the pipeline is built so no optimization can change any value:

* every float *product* is EXACT: operands are kept at <= 26
  significant bits (f32-valued, or small integers), so the f64
  product has <= 52 mantissa bits and rounds to itself — an FMA
  contraction of ``a*b + c`` then rounds identically to the separate
  ops
* values re-enter the <= 26-bit domain via explicit precision
  reduction (``lax.reduce_precision`` / f32 casts), an HLO with
  defined semantics the compiler must honor
* additions are plain f64 adds in a fixed binary-tree order (adds
  cannot contract with adds), and integer-valued f64 sums below 2^53
  are exact in any order
* transcendental outputs (log) are immediately rounded to f32
  precision, collapsing sub-ulp libm/XLA differences

On a GPU, f64 is native IEEE and the NVPTX backend contracts
multiply-adds freely; the exact-product rule above makes every such
contraction round to the same value (``chip_smoke.py`` holds the
encoder byte-identical to the numpy backend on the card).

**float-float f64 (x64 emulation).**  Where an accelerator has no
native f64, XLA's x64 rewriter emulates it as a (hi, lo) *pair of
f32s* (~49-bit significand, non-IEEE rounding): ``exp2`` of integral
arguments is NOT exact, general (non-integer) f64 add chains round
differently than IEEE f64, and f64 division is approximate.  The spec
holds under that emulation too, so it tightens further:

* every value is either an INTEGER below 2^47 (exactly representable
  and exactly summable as two f32s, in any order) or an f32-VALUED
  float (lo half zero); products of two f32-valued numbers (<= 48
  mantissa bits) and sums of two f32-valued numbers (<= 49 bits) are
  exact in float-float via two-product/two-sum, so rounding them back
  to f32 matches IEEE f64 bit-for-bit
* powers of two come from ``exact_exp2`` (IEEE-754 bit construction,
  never the transcendental ``exp2``)
* the windowed autocorrelation quantizes windowed samples to
  integers so its lag sums are exact integer sums, immune to any
  reduction reordering or fusion
* the one remaining approximation is division (Levinson's reflection
  coefficients): both backends round the quotient to f32, which can
  differ only when the emulation's ~2^-49 quotient error straddles an
  f32 rounding boundary (~2^-25 per division; decisions only steer
  encoding, losslessness is unaffected)

All functions take an ``xp`` module (numpy or jax.numpy) and operate on
arrays whose leading dimensions are batch dims.
"""

from __future__ import annotations

import numpy as np

_window_cache = {}


def f32round(xp, x):
    """explicitly rounds f64 values to f32 precision (keeping f64 type)

    This is the spec's precision-reduction primitive: products of two
    f32-valued f64 numbers are exact in f64, which makes every
    multiply-add chain immune to FMA contraction and excess-precision
    evaluation (see module docstring).

    Implemented as convert-to-f32 / convert-back (lowerable on every
    backend — an x64-emulating rewriter cannot lower f64
    reduce_precision)
    with an optimization barrier between the converts so
    allow-excess-precision cannot elide the downcast/upcast pair."""
    if xp is np:
        return x.astype(np.float32).astype(np.float64)
    import jax.lax
    y = x.astype(xp.float32)
    y = jax.lax.optimization_barrier(y)
    return y.astype(xp.float64)


def tukey_window(n, alpha=0.5):
    """the tukey window exactly as the reference computes it
    (py_encoders/flac.py:565-582); float64, computed once on host"""
    key = (n, alpha)
    if key not in _window_cache:
        window1 = (alpha * (n - 1)) / 2
        window2 = (n - 1) * (1 - (alpha / 2))
        out = np.empty(n, dtype=np.float64)
        for i in range(n):
            if i <= window1:
                out[i] = 0.5 * (1 + np.cos(
                    np.pi * (((2 * i) / (alpha * (n - 1))) - 1)))
            elif i <= window2:
                out[i] = 1.0
            else:
                out[i] = 0.5 * (1 + np.cos(
                    np.pi * (((2 * i) / (alpha * (n - 1))) -
                             (2 / alpha) + 1)))
        _window_cache[key] = out
    return _window_cache[key]


_window_df_cache = {}


def tukey_window_df(n, alpha=0.5):
    """the tukey window split into a double-f32 (hi, lo) pair ON HOST

    The split MUST happen in IEEE f64 (numpy): splitting a traced
    window on an x64-emulating backend would derive the lo half from the
    float-float representation of the f64 constant, whose ~2^-49
    representation error sits at the lo half's own last-bit scale —
    a few percent of elements would round differently than on CPU,
    breaking cross-backend byte identity.  Both halves here are
    f32-valued, so their device representation is exact everywhere."""
    key = (n, alpha)
    if key not in _window_df_cache:
        w = tukey_window(n, alpha)
        hi = w.astype(np.float32).astype(np.float64)
        lo = (w - hi).astype(np.float32).astype(np.float64)
        _window_df_cache[key] = (hi, lo)
    return _window_df_cache[key]


def exact_exp2(xp, e):
    """exact 2^e for integer arrays, as float64

    Built from the IEEE-754 bit pattern ((e + 1023) << 52) rather than
    the transcendental ``exp2``, which is NOT exact for integral
    arguments under x64 float-float emulation.  Exponents
    clamp to the normal range [-1022, 1023]."""
    if xp is np:
        e = np.clip(np.asarray(e).astype(np.int64), -1022, 1023)
        return ((e + 1023) << 52).view(np.float64)
    import jax.lax
    e = xp.clip(xp.asarray(e).astype(xp.int64), -1022, 1023)
    return jax.lax.bitcast_convert_type((e + 1023) << 52, xp.float64)


def int_bit_length(xp, v):
    """bit_length of non-negative int32/int64 arrays (0 -> 0)

    pure integer compares — deterministic on every backend"""
    v = xp.asarray(v)
    out = xp.zeros(v.shape, dtype=xp.int32)
    for k in range(31):
        out = out + (v >= (1 << k)).astype(xp.int32)
    return out


def windowed_autocorr_df(xp, samples, window, max_order):
    """two-plane windowed autocorrelation, ~2^-39 relative accuracy

    samples: int [..., n] (post-wasted-shift); window: f64 [n].
    Returns a double-f32 pair (hi, lo), each f64 [..., max_order+1].

    The single-plane spec (17-bit quantized windowed integers) is
    exact and backend-deterministic but feeds Levinson only ~22
    significant bits — measured as 4-8x worse predictors than the
    reference's f64 analysis on near-singular (tonal) autocorrelation
    (reference hot loop: src/encoders/flac.c flac_compute_autocorrelation,
    plain f64).  This version keeps every sum an exact integer sum and
    adds a SECOND quantization plane:

    * the window splits into a df pair (wh, wl) on host (numpy), so
      windowing products ``xs*wh`` / ``xs*wl`` stay exact (<= 41 bits)
    * plane 1 ``u = floor(xs*wh*2^s0 + 0.5)`` is the established
      single-plane quantization (identical construction and risk
      envelope); the residue ``r = y - u`` is exact and f32-valued
      (span <= 40 - m <= 24 bits for the m >= 16 this function
      requires)
    * plane 2 ``v = floor((r + R(xs*wl*2^s0)) * 2^17 + 0.5)`` re-uses
      only contract ops; the +0.5 sum spans <= 42 bits (exact on both
      backends — cleaner than plane 1's own bound)
    * three exact integer reduces (u*u, cross, v*v — all below 2^47)
      recombine as ``(S_uu*2^34 + S_cross*2^17 + S_vv) * 2^-2(17+s0)``
      through df.from_parts, every term an exact f64

    Windowed values thus carry ~34 significant bits and the df
    accumulation ~45, so autocorrelation accuracy lands at ~2^-39
    relative — enough for Levinson to match f64 predictor choices on
    the reference's tone corpus (measured in BASELINE.md).  The 17-bit
    sample pre-shift for >17-bit inputs is unchanged (it bounds plane
    products; >=18-bit content loses sample bits exactly as before).
    """
    from . import df as dfm
    n = samples.shape[-1]
    if isinstance(window, tuple):
        # pre-split (hi, lo) pair — REQUIRED inside jit traces (see
        # tukey_window_df: the split itself must run in host IEEE f64)
        (wh, wl) = window
    else:
        w64 = np.asarray(window, dtype=np.float64)
        wh = w64.astype(np.float32).astype(np.float64)
        wl = (w64 - wh).astype(np.float32).astype(np.float64)
        if xp is not np:
            wh = xp.asarray(wh)
            wl = xp.asarray(wl)
    amax = xp.max(xp.abs(samples), axis=-1, keepdims=True)
    pre = xp.maximum(int_bit_length(xp, amax) - 17, 0)     # [..., 1]
    xs = (samples >> pre).astype(xp.float64)
    a = xs * wh                                            # exact
    b = xs * wl                                            # exact
    nb = 1
    while (1 << nb) < n:
        nb += 1
    m = min((47 - nb) // 2, 23)
    s0 = m - 17
    y = a * float(exact_exp2(np, s0))                      # exact
    u = xp.floor(y + 0.5)
    if m >= 16:
        r = y - u                                          # exact, f32
        b2 = f32round(xp, b * float(exact_exp2(np, s0)))
        t = f32round(xp, r + b2)
        v = xp.floor(t * 131072.0 + 0.5)
    else:
        # blocks past ~32k samples: the residue r is no longer
        # f32-valued (span > 24 bits), so the second plane's exactness
        # argument fails — degrade to the single-plane spec (v = 0)
        v = xp.zeros_like(u)
    lags_uu = []
    lags_cross = []
    lags_vv = []
    for lag in range(max_order + 1):
        u0 = u[..., :n - lag]
        u1 = u[..., lag:]
        v0 = v[..., :n - lag]
        v1 = v[..., lag:]
        lags_uu.append(xp.sum(u0 * u1, axis=-1))
        lags_cross.append(xp.sum(u0 * v1 + v0 * u1, axis=-1))
        lags_vv.append(xp.sum(v0 * v1, axis=-1))
    S_uu = xp.stack(lags_uu, axis=-1)
    S_cross = xp.stack(lags_cross, axis=-1)
    S_vv = xp.stack(lags_vv, axis=-1)
    acc = dfm.from_parts(xp, S_uu * float(exact_exp2(np, 34)),
                         S_cross * float(exact_exp2(np, 17)), S_vv)
    scale = exact_exp2(xp, 2 * (pre.astype(xp.int64) - 17 - s0))
    return (acc[0] * scale, acc[1] * scale)


def levinson_df(xp, ac, max_order):
    """batched Levinson-Durbin in double-f32 (~45-bit) arithmetic

    ac: df pair (hi, lo), each f64 [..., max_order+1], e.g. from
    windowed_autocorr_df.  Returns (coeffs, errors) with the SAME
    output contract as the single-f32 recursion had: coeffs f64
    [..., max_order, max_order] and errors f64 [..., max_order], both
    f32-VALUED (one exact hi+lo sum, one f32 rounding), so the
    downstream quantize/estimate/residual stages are untouched.

    Every step is an ops/df primitive (built from the
    single-op-then-round contract), so cross-backend determinism is
    inherited; divisions keep the documented ~2^-25-band float-float
    caveat (two per reflection coefficient instead of one).
    Degenerate rows (zero lag-0 or zero intermediate error) yield
    ki = 0 continuations via df.div's zero-denominator guard.
    """
    from . import df as dfm
    (ach, acl) = ac
    batch = ach.shape[:-1]
    K = max_order

    def at(i):
        return (ach[..., i], acl[..., i])

    zeros = xp.zeros(batch + (K,), dtype=xp.float64)
    one = (xp.ones(batch, dtype=xp.float64),
           xp.zeros(batch, dtype=xp.float64))
    k0 = dfm.div(xp, at(1), at(0))
    rowh = _set_col(xp, zeros, 0, k0[0])
    rowl = _set_col(xp, xp.zeros_like(zeros), 0, k0[1])
    rows = [(rowh, rowl)]
    errors = [dfm.mul(xp, at(0),
                      dfm.sub(xp, one, dfm.mul(xp, k0, k0)))]

    for i in range(1, K):
        (ph, pl) = rows[i - 1]
        acc = (xp.zeros(batch, dtype=xp.float64),
               xp.zeros(batch, dtype=xp.float64))
        for j in range(i):
            acc = dfm.add(xp, acc, dfm.mul(
                xp, (ph[..., j], pl[..., j]), at(i - j)))
        err_prev = errors[i - 1]
        ki = dfm.div(xp, dfm.sub(xp, at(i + 1), acc), err_prev)
        nh = xp.zeros(batch + (K,), dtype=xp.float64)
        nl = xp.zeros_like(nh)
        for j in range(i):
            tj = dfm.mul(xp, ki, (ph[..., i - 1 - j],
                                  pl[..., i - 1 - j]))
            nj = dfm.sub(xp, (ph[..., j], pl[..., j]), tj)
            nh = _set_col(xp, nh, j, nj[0])
            nl = _set_col(xp, nl, j, nj[1])
        nh = _set_col(xp, nh, i, ki[0])
        nl = _set_col(xp, nl, i, ki[1])
        rows.append((nh, nl))
        errors.append(dfm.mul(xp, err_prev,
                              dfm.sub(xp, one, dfm.mul(xp, ki, ki))))

    coeffs = xp.stack([dfm.to_f32(xp, row) for row in rows], axis=-2)
    errs = xp.stack([dfm.to_f32(xp, e) for e in errors], axis=-1)
    return (coeffs, errs)


def lpc_residuals_i32(xp, samples, qlp, shifts, clip_bits):
    """batched integer LPC residuals for every order row, exact

    samples: int32 [S, n] (post-wasted-shift)
    qlp:     int32 [S, K, K] quantized coefficients (row o-1 = order o)
    shifts:  int32 [S, K]
    returns res int32 [S, K, n] with warm-up positions (< order) zeroed

    The prediction accumulator can exceed int32 (|q|<2^13, |x|<2^25),
    so samples split into hi/lo halves (x = hi*2^11 + lo, 0 <= lo <
    2^11) and accumulate separately in int32 — the O(K^2 n) hot loop
    stays native int32 (no f64 at all).  The recombination
    floor((A*2^11 + B) / 2^s) is ALSO pure int32, by shift splitting
    (the f64 form it replaces was the residual stage's top cost under
    float-float emulation):

      s <= 11:  A*2^11 is a multiple of 2^s, so the floor splits
                exactly: pred = (A << (11-s)) + (B >> s) (arithmetic
                shifts are floor division).  A first SATURATES to
                +-2^(19+s) so the left shift cannot wrap int32
                (|pred| <= 2^30 + |B| < 2^31); saturation only
                triggers for degenerate trials whose residual lands
                beyond +-2^clip_bits on BOTH the exact and the
                saturated path (|pred| >= 2^30 - 2^28 far exceeds
                every clip bound, same sign), so the clipped result
                is identical to the exact-f64 form.
      s >= 12:  nested floors: floor(T/2^s) =
                floor(floor(T/2^11)/2^(s-11)) with floor(T/2^11) =
                A + (B >> 11) exact — no headroom needed.

    The caller guarantees the int32 ACCUMULATION cannot wrap
    (hi_bits <= 30, see lpc_residuals); the quantizer clamps
    shifts to [0, 15]."""
    S = samples.shape[0]
    n = samples.shape[1]
    K = qlp.shape[1]
    xhi = samples >> 11
    xlo = samples & 2047
    hi_pad = xp.pad(xhi, [(0, 0), (K, 0)])
    lo_pad = xp.pad(xlo, [(0, 0), (K, 0)])
    A = xp.zeros((S, K, n), dtype=xp.int32)
    Bv = xp.zeros((S, K, n), dtype=xp.int32)
    for j in range(K):
        # prediction for position i uses sample i-1-j
        q = qlp[:, :, j][:, :, None]
        A = A + q * hi_pad[:, None, K - 1 - j:K - 1 - j + n]
        Bv = Bv + q * lo_pad[:, None, K - 1 - j:K - 1 - j + n]
    s = shifts[:, :, None].astype(xp.int32)
    s_le = xp.minimum(s, 11)
    cap = xp.left_shift(xp.int32(1 << 19), s_le)       # 2^(19+s)
    A_sat = xp.clip(A, -cap, cap)
    pred_lo = xp.left_shift(A_sat, 11 - s_le) + (Bv >> s_le)
    pred_hi = (A + (Bv >> 11)) >> (xp.maximum(s, 11) - 11)
    pred = xp.where(s <= 11, pred_lo, pred_hi)
    res = samples[:, None, :] - pred
    # degenerate candidates (tiny shift, huge coeffs) can exceed the
    # downstream |residual| bound; clip keeps such trials
    # maximal-but-bounded so they lose every argmin (same semantics
    # as lpc_residuals_f64)
    bound = xp.int32(1 << clip_bits)
    res = xp.clip(res, -bound, bound)
    pos = xp.arange(n, dtype=xp.int32)[None, None, :]
    order_arr = xp.arange(1, K + 1, dtype=xp.int32)[None, :, None]
    return xp.where(pos < order_arr, 0, res).astype(xp.int32)


def lpc_residuals_f64(xp, samples, qlp, shifts, clip_bits):
    """batched integer LPC residuals via exact f64 accumulation

    The wide-bound path (whenever the hi/lo int32 scheme's
    intermediates could exceed int32 — e.g. ``A << (11 - s)`` reaches
    2^33 for 24-bit input with small shifts and wraps to an ALIASED
    SMALL residual, which under-sizes Rice parameters and explodes the
    emitters' unary coding): every product q * x is of integers below
    2^14 and 2^26, so the f64 product (< 2^40) is exact, the <= 32
    term sum stays below 2^45 — exact in any order even under
    float-float f64 (representable bound ~2^47), immune to FMA
    contraction by exactness — and the arithmetic shift is an exact
    power-of-two scale (exact_exp2) + floor.

    Residuals beyond +-2^clip_bits (only reachable through degenerate
    predictor trials, never by a sane candidate) clip to the bound:
    float->int32 overflow casts are NOT backend-deterministic, and the
    clipped value keeps |residual| sums maximal-but-bounded so such
    candidates draw maximal Rice parameters and lose every argmin.
    Bit-deterministic on every backend; same semantics as
    ``lpc_residuals_i32`` within its exact range."""
    S = samples.shape[0]
    n = samples.shape[1]
    K = qlp.shape[1]
    x = samples.astype(xp.float64)
    x_pad = xp.pad(x, [(0, 0), (K, 0)])
    acc = xp.zeros((S, K, n), dtype=xp.float64)
    for j in range(K):
        q = qlp[:, :, j].astype(xp.float64)[:, :, None]
        acc = acc + q * x_pad[:, None, K - 1 - j:K - 1 - j + n]
    scale = exact_exp2(xp, -shifts)[:, :, None]
    pred = xp.floor(acc * scale)
    res = samples[:, None, :].astype(xp.float64) - pred
    bound = float(1 << clip_bits)
    res = xp.clip(res, -bound, bound)
    pos = xp.arange(n, dtype=xp.int32)[None, None, :]
    order_arr = xp.arange(1, K + 1, dtype=xp.int32)[None, :, None]
    return xp.where(pos < order_arr, 0.0, res).astype(xp.int32)


def lpc_residuals(xp, samples, qlp, shifts, value_bits, precision,
                  clip_bits):
    """dispatches between the int32 hi/lo and exact-f64 residual paths

    value_bits: static bound on bits of |samples| (bps + 1 for side
    channels, post-wasted-shift upper bound).  The int32 scheme is
    used only when its ACCUMULATORS cannot wrap AND its saturating
    recombination is provably clip-equivalent to the exact value:

    * A = sum q*xhi bounded by K * 2^(precision-1) *
      2^(max(value_bits-11,0)) must stay below 2^31, and
    * Bv = sum q*xlo bounded by K * 2^(precision-1) * 2^11 must stay
      <= 2^29: the s <= 11 recombination saturates A to +-2^(19+s)
      before the left shift, and the saturated prediction
      +-(2^30 + Bv>>s) only provably exceeds every clip bound (so
      clips identically to the exact-f64 form) when |Bv| cannot
      near-cancel the 2^30 term — at K = 32, precision = 15 the Bv
      bound reaches 2^30 and a degenerate saturated trial could land
      IN bounds with the wrong value, diverging from the scalar
      oracle's decisions.

    16-bit stereo at precision 14 / order 12 qualifies and keeps the
    O(K^2 n) hot loop in native int32.  Otherwise the f64 path
    computes the true value exactly (products fit 2^53 / float-float
    2^47 for all audio), clipped to +-2^clip_bits (see
    lpc_residuals_f64)."""
    K = qlp.shape[1]
    import math
    logk = math.ceil(math.log2(max(K, 1)))
    hi_bits = logk + (precision - 1) + max(value_bits - 11, 0)
    bv_bits = logk + (precision - 1) + 11
    if hi_bits < 31 and bv_bits <= 29:
        return lpc_residuals_i32(xp, samples, qlp, shifts, clip_bits)
    return lpc_residuals_f64(xp, samples, qlp, shifts, clip_bits)


def _set_col(xp, arr, col, values):
    """sets arr[..., col] = values, backend-agnostic"""
    if xp is np:
        arr = arr.copy() if not arr.flags.writeable else arr
        arr[..., col] = values
        return arr
    else:
        return arr.at[..., col].set(values)


def ilog2_trunc(xp, values):
    """exact int(log2(v)) truncated toward zero for v > 0

    deterministic across backends: an approximate log2 seeds an exact
    floor which is then corrected with exact power-of-two comparisons
    (powers of two from exact_exp2 — the transcendental exp2 is NOT
    exact for integral args under float-float f64)"""
    approx = xp.floor(xp.log2(values))
    # correct the floor estimate by at most one step each way
    approx = xp.where(
        exact_exp2(xp, approx + 1.0) <= values, approx + 1.0, approx)
    approx = xp.where(
        exact_exp2(xp, approx) > values, approx - 1.0, approx)
    exact_power = exact_exp2(xp, approx) == values
    # truncation toward zero: for v >= 1 trunc == floor; for v < 1
    # (log2 < 0) trunc == floor + 1 unless v is an exact power of two
    trunc = xp.where((values >= 1.0) | exact_power, approx, approx + 1.0)
    return trunc.astype(xp.int32)


def frexp_exponent(xp, values):
    """exact frexp exponent for v > 0: e with v = m * 2^e, m in
    [0.5, 1) — i.e. floor(log2(v)) + 1

    Same exact-correction construction as ilog2_trunc; xp.frexp itself
    is unusable on device (its s64 bitcast is rejected by XLA's x64
    emulation rewriter)."""
    approx = xp.floor(xp.log2(values))
    approx = xp.where(
        exact_exp2(xp, approx + 1.0) <= values, approx + 1.0, approx)
    approx = xp.where(
        exact_exp2(xp, approx) > values, approx - 1.0, approx)
    # v == 2^k has floor(log2) == k and frexp exponent k + 1
    return (approx + 1.0).astype(xp.int32)


def quantize_all_orders(xp, coeffs, precision):
    """batched error-feedback coefficient quantization for every order

    coeffs: f64 [..., K, K] from levinson()
    returns (qlp int32 [..., K, K], shifts int32 [..., K]) where row
    o-1 holds the order-o quantized coefficients; mirrors reference
    py_encoders/flac.py:702-737 (negative shifts clamp to 0 with
    coefficients divided instead)
    """
    K = coeffs.shape[-1]
    # max |coeff| per order row, over the valid prefix
    order_idx = xp.arange(K)
    valid = order_idx[None, :] <= order_idx[:, None]      # [K, K]
    abs_coeffs = xp.abs(coeffs)
    masked = xp.where(valid, abs_coeffs, 0.0)
    l = xp.max(masked, axis=-1)                           # [..., K]

    has_l = l > 0
    safe_l = xp.where(has_l, l, 1.0)
    # frexp exponent (reference src/encoders/flac.c:1294 frexp):
    # l = m * 2^e with m in [0.5, 1).  NOT int(log2(l)): for
    # coefficients in [1, 2) — every near-unit-circle predictor, i.e.
    # all tonal content — the log-trunc form (the reference's PYTHON
    # mirror, py_encoders/flac.py:710) over-shifts by one and clamps
    # the lead coefficient at the precision boundary, costing ~40-90%
    # compression on pure tones.  The C encoder that produced the
    # reference corpus uses frexp; this framework follows the C
    # (production) semantics.
    e = frexp_exponent(xp, safe_l)
    raw_shift = xp.clip((precision - 1) - (e - 1) - 1,
                        -(1 << 4), (1 << 4) - 1)
    raw_shift = xp.where(has_l, raw_shift, 0)

    # effective multiplier: 2^shift for shift >= 0, else 1/2^-shift
    # with the emitted shift clamped to 0
    shift_nonneg = xp.maximum(raw_shift, 0)
    # exact_exp2 covers negatives directly (2^-k is exact), so no
    # reciprocal needed
    scale = exact_exp2(xp, raw_shift)

    qlp_max = (1 << (precision - 1)) - 1
    qlp_min = -(1 << (precision - 1))

    error = xp.zeros(l.shape, dtype=xp.float64)
    cols = []
    for j in range(K):
        # scale is an exact power of two, so the product is exact
        # (contraction-immune); the candidate re-rounds to f32 so the
        # integer rounding below sees an identical f32-valued input
        # under IEEE f64 and float-float alike
        contribution = coeffs[..., j] * scale                # [..., K]
        active = valid[:, j]                                 # [K]
        error_candidate = f32round(xp, error + contribution)
        # C semantics: round half away from zero (C round()), and the
        # error feedback subtracts the UNCLAMPED rounded value
        # (src/encoders/flac.c:1308-1311) — exact: candidate is
        # f32-valued, so |x| + 0.5 and the floor are exact in f64
        rounded = xp.sign(error_candidate) * xp.floor(
            xp.abs(error_candidate) + 0.5)
        q = xp.clip(rounded, qlp_min, qlp_max)
        new_error = error_candidate - rounded
        q = xp.where(active, q, 0.0)
        error = xp.where(active, new_error, error)
        cols.append(q.astype(xp.int32))
    qlp = xp.stack(cols, axis=-1)
    return (qlp, shift_nonneg.astype(xp.int32))


def estimate_best_lpc_order(xp, errors, block_size, bits_per_sample,
                            qlp_precision, max_lpc_order):
    """batched log-domain order estimate (py_encoders/flac.py:676)

    errors: f64 [..., K]; bits_per_sample: int array broadcastable to
    the batch shape; returns int32 order per batch element.

    replicates the reference's loop: orders with error > 0 compete on
    estimated bits (strict <, earliest wins); the first order with
    error == 0.0 exactly wins immediately.
    """
    # spec constant defined at f32 precision so err * error_scale is
    # an exact product (26-bit * 24-bit operands)
    error_scale = float(np.float32(np.log(2) ** 2))
    K = max_lpc_order

    bps = xp.asarray(bits_per_sample)
    best_order = xp.zeros(errors.shape[:-1], dtype=xp.int32)
    best_bits = xp.full(errors.shape[:-1], 1e32, dtype=xp.float64)
    found_zero = xp.zeros(errors.shape[:-1], dtype=bool)

    for i in range(K):
        order = i + 1
        err = errors[..., i]
        header_bits = order * (bps + qlp_precision)
        # log output rounds to f32 precision immediately: collapses
        # sub-ulp libm/XLA/float-float differences; the constant
        # divide becomes a multiply by an f32-rounded reciprocal so
        # the product is exact (two f32-valued operands) — float-float
        # division is approximate and would reintroduce divergence
        log_err = f32round(xp, xp.log(
            xp.where(err > 0.0, err * error_scale, 1.0)))
        inv_2log2 = float(np.float32(1.0 / (np.log(2) * 2)))
        bits_per_residual = f32round(
            xp, xp.maximum(log_err * inv_2log2, 0.0))
        estimated = header_bits + bits_per_residual * (block_size -
                                                       order)

        improves = (err > 0.0) & (estimated < best_bits) & ~found_zero
        best_order = xp.where(improves, order, best_order)
        best_bits = xp.where(improves, estimated, best_bits)

        is_zero = (err == 0.0) & ~found_zero
        best_order = xp.where(is_zero, order, best_order)
        found_zero = found_zero | is_zero

    return best_order
