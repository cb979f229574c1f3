"""Batched FLAC subframe analysis and decision kernels.

The batched re-expression of the reference encoder's per-sample trial
loops (``/root/reference/src/encoders/flac.c:79-120`` and its spec
``audiotools/py_encoders/flac.py:166-563``): subframe trials, LPC order
sweeps and Rice partition searches become *vectorized argmins over
candidate axes* on ``[subframes, block_size]`` tensors.

``analyze_subframes(xp, ...)`` is backend-generic: ``xp`` may be numpy
(host path / oracle cross-check) or jax.numpy inside ``jit`` (device
path).  Both backends produce byte-identical streams.

Dtype discipline (the kernel must stay exact where f64 is emulated,
and f64 is the slow path even where it is native):

* all big ``[.., n]`` tensors are **int32** (residual stacks, zigzag
  values, diffs) or **float32** (the windowed autocorrelation inputs)
* integer reductions that may exceed 32 bits run *two-stage*: int32
  partial sums over 64-element chunks (exact — bounded by 64*max|x|),
  promoted to f64 and combined (f64 adds of integers are exact and
  order-independent while totals stay < 2^47 — the representable
  bound of float-float (f32-pair) f64 emulation, stricter than IEEE
  f64's 2^53; all totals here are bit counts or |residual| sums far
  below it), so results equal the mathematically exact sums on every
  backend
* LPC prediction uses the hi/lo-split int32 scheme in
  ``ops.lpc.lpc_residuals_i32``
* only tiny ``[S, K]``-shaped tensors (Levinson, quantization, order
  estimates, subframe bit totals) stay in f64

Decision semantics replicated from the reference:
* wasted bits = trailing zeros of the OR over all samples
* FIXED order selection from abs-error sums over diff orders 0-4
* LPC exhaustive search: first-minimum over orders (strict <)
* Rice search: partition orders 0..max (block_size divisible by
  2^porder, contiguous ascending), parameter from the abs-sum
  threshold loop, size = sum(4 + sum(u>>r) + count*(1+r)),
  first-minimum over porder; subframe-level comparisons add the
  coding-method-1 5-bit parameter correction
* verbatim-vs-fixed-vs-LPC comparison incl. the bps*n verbatim quirk
"""

from __future__ import annotations

import os

import numpy as np

from . import lpc as lpc_ops

# see the zigzag barrier note in analyze_subframes
_ZIGZAG_BARRIER = os.environ.get("ATPU_ZIGZAG_BARRIER", "") not in ("", "0")

(CHOICE_CONSTANT, CHOICE_VERBATIM, CHOICE_FIXED, CHOICE_LPC) = range(4)

# packed decision row layout (int32), per subframe:
#   [choice, wasted, order, porder, shift, sub_bits, qlp*K, rice*P]
# full row: [assignment] + max_subframes * W where W = 6 + K + P
PACKED_SCALARS = 6


def _rice_mode():
    """the analysis-stage Rice search flavor ("estimate" | "exact");
    shared spec with the scalar oracle
    (ref/flac_analysis.rice_search_mode) — read at TRACE time, so
    jitted callers must key their caches on it"""
    return os.environ.get("ATPU_DEVICE_RICE", "estimate")


def _scope(xp, name):
    """jax.named_scope(name) for the jax backend (stage names appear
    in XLA profiles / HLO dumps, SURVEY.md par.5's tracing hook); a
    null context for the NumPy oracle backend"""
    if xp is np:
        import contextlib
        return contextlib.nullcontext()
    import jax
    return jax.named_scope(name)


def packed_width(max_lpc_order, max_parts):
    """per-subframe width of the packed decision layout"""
    return PACKED_SCALARS + max(max_lpc_order, 1) + max_parts


def compact_width(max_lpc_order, max_parts):
    """per-subframe width of the COMPACT decision layout (the wire
    format for device->host decision downloads): one bit-packed
    scalar word [choice(4b) | wasted<<4 (6b) | order<<10 (6b) |
    porder<<16 (4b) | shift<<20 (5b)], qlp coefficients as int16
    pairs, Rice parameters as u8 quads — 3.5x smaller than the
    standard layout (sub_bits, which no emitter reads, is dropped)"""
    Kp = max(max_lpc_order, 1)
    return 1 + (Kp + 1) // 2 + (max_parts + 3) // 4


def compact_decisions(xp, packed, max_subframes, max_lpc_order,
                      max_parts):
    """converts [B, 1 + S*W] standard decision rows to the compact
    layout [B, 1 + S*CW] (see compact_width); runs on device inside
    the analysis jit so the host fetch shrinks 3.5x.  The C++ emitter
    (`atpu_flac_emit_frames2` with compact=1) reverses this exactly."""
    Kp = max(max_lpc_order, 1)
    P = max_parts
    W = PACKED_SCALARS + Kp + P
    B = packed.shape[0]
    rows = xp.reshape(packed[:, 1:], (B, max_subframes, W))
    choice = rows[:, :, 0]
    wasted = rows[:, :, 1]
    order = rows[:, :, 2]
    porder = rows[:, :, 3]
    shift = rows[:, :, 4]
    w0 = (choice | (wasted << 4) | (order << 10) | (porder << 16) |
          (shift << 20))
    qlp = rows[:, :, PACKED_SCALARS:PACKED_SCALARS + Kp] & 0xFFFF
    if Kp % 2:
        qlp = xp.pad(qlp, [(0, 0), (0, 0), (0, 1)])
    qpair = qlp[:, :, 0::2] | (qlp[:, :, 1::2] << 16)
    rice = rows[:, :, PACKED_SCALARS + Kp:] & 0xFF
    if P % 4:
        rice = xp.pad(rice, [(0, 0), (0, 0), (0, (-P) % 4)])
    rquad = (rice[:, :, 0::4] | (rice[:, :, 1::4] << 8) |
             (rice[:, :, 2::4] << 16) | (rice[:, :, 3::4] << 24))
    per_sub = xp.concatenate([w0[:, :, None], qpair, rquad], axis=2)
    return xp.concatenate(
        [packed[:, :1], xp.reshape(per_sub, (B, -1))],
        axis=1).astype(xp.int32)


def build_variants(xp, blocks, stereo_trial, bps):
    """builds the candidate channel stack from [B, n, ch] blocks

    stereo trials produce the [left, right, mid, side] variants per
    frame (mid = floor((L+R)/2), side = L-R); otherwise each channel
    stands alone.  returns (X [B*V, n] int32, bps_vec [B*V] int32)"""
    B = blocks.shape[0]
    n = blocks.shape[1]
    if stereo_trial:
        left = blocks[:, :, 0].astype(xp.int32)
        right = blocks[:, :, 1].astype(xp.int32)
        average = (left + right) >> 1
        difference = left - right
        X = xp.stack([left, right, average, difference],
                     axis=1)                               # [B, 4, n]
        bps_vec = xp.tile(
            xp.asarray([bps, bps, bps, bps + 1], dtype=xp.int32), B)
        V = 4
    else:
        ch = blocks.shape[2]
        X = xp.swapaxes(blocks, 1, 2).astype(xp.int32)     # [B, ch, n]
        bps_vec = xp.full(B * ch, bps, dtype=xp.int32)
        V = ch
    return (xp.reshape(X, (B * V, n)), bps_vec)


def valid_partition_orders(block_size, max_porder, max_pred_order):
    """the contiguous list of partition orders the search visits

    stops at the first porder where block_size stops dividing evenly
    (reference src/encoders/flac.c:1389-1393) or where the first
    partition would go non-positive"""
    porders = []
    for porder in range(0, max_porder + 1):
        if block_size % (1 << porder):
            break
        if (porder > 0) and ((block_size >> porder) <= max_pred_order):
            break
        porders.append(porder)
    return porders


def popcount32(xp, v):
    """population count of uint32 values, backend-generic"""
    if xp is np:
        return np.bitwise_count(v.astype(np.uint32)).astype(np.int32)
    else:
        import jax.lax
        return jax.lax.population_count(
            v.astype(xp.uint32)).astype(xp.int32)


def _exp2i(xp, e):
    """exact 2^e for (possibly negative) integer arrays, as float64

    via IEEE bit construction — the transcendental ``exp2`` is NOT
    exact for integral args under float-float f64 emulation"""
    return lpc_ops.exact_exp2(xp, e)


_CHUNK = 64


def sum_chunk_for(value_bits):
    """largest power-of-two chunk whose int32 partial sums cannot wrap

    chunk * 2^value_bits < 2^31  =>  chunk = 2^clamp(30 - value_bits,
    0, 6); value_bits is a static bound on bits of |summand|.  chunk 1
    degenerates to a pure (still exact) f64 sum."""
    return 1 << max(0, min(6, 30 - value_bits))


def exact_i32_sum(xp, x, axis=-1, chunk=_CHUNK):
    """exact f64 sum of int32 values along the last axis

    two-stage: int32 partial sums over `chunk`-element groups (the
    caller bounds |x| so partials cannot wrap — see sum_chunk_for),
    then f64 combination — exact in any order for integer totals
    below the representable bound (2^53 IEEE, ~2^47 under
    float-float f64 emulation; all totals here are far below both).
    the input is zero-padded to a chunk multiple."""
    assert axis in (-1, x.ndim - 1)
    if chunk <= 1:
        return pairwise_i32_f64_sum(xp, x)
    n = x.shape[-1]
    pad = (-n) % chunk
    if pad:
        padding = [(0, 0)] * (x.ndim - 1) + [(0, pad)]
        x = xp.pad(x, padding)
    chunked = xp.reshape(x, x.shape[:-1] + ((n + pad) // chunk, chunk))
    partial = xp.sum(chunked, axis=-1, dtype=xp.int32)
    return xp.sum(partial.astype(xp.float64), axis=-1)


def pairwise_i32_f64_sum(xp, x):
    """exact f64 sum of int32 values (no int32 stage): every int32 is
    exact in f64 and integer f64 sums are exact in any order while
    totals stay representable (2^53 IEEE, ~2^47 float-float), so
    this is deterministic on every backend"""
    return xp.sum(x.astype(xp.float64), axis=-1)


def analyze_subframes(xp, X, bps, n, max_lpc_order, qlp_precision,
                      porders, max_rice, exhaustive, window,
                      or_all=None, const_flag=None, max_bps=25):
    """runs all subframe trials for a batch of channels

    X:   int32 [S, n] decorrelated channel data
    bps: int32 [S] bits per sample of each subframe (side = bps+1)
    n, max_lpc_order, qlp_precision, porders (list of valid partition
    orders), max_rice, exhaustive: static Python values
    window: [n] analysis window (host constant; cast to f32)
    or_all / const_flag: optional [S] exactness sideband (see
    ops/qpack.py) — the OR of all *exact* samples and the exact
    is-constant flags.  When X carries quantized samples these MUST be
    supplied: wasted-bits and CONSTANT choices are the two decisions
    the emitters trust for losslessness, so they are always derived
    from exact data (here or from X itself when X is exact).
    max_bps: static bound on bits of |X| — sizes the int32 partial-sum
    chunks and the residual-path dispatch so no intermediate can wrap
    (wrapped int32 sums once produced catastrophically small Rice
    parameters whose unary coding overran the emit buffer).

    returns a dict of [S]-leading arrays describing the chosen
    subframe encodings plus their exact bit sizes (float64 integers)
    """
    S = X.shape[0]
    K = max_lpc_order
    X = X.astype(xp.int32)
    bps = xp.asarray(bps, dtype=xp.int32)
    bps_f = bps.astype(xp.float64)

    # ---- constant detection -------------------------------------------
    if const_flag is None:
        const_flag = xp.all(X == X[:, :1], axis=1)
    else:
        const_flag = xp.asarray(const_flag).astype(bool)
    const_val = X[:, 0]

    # ---- wasted bits ---------------------------------------------------
    # min trailing zeros over samples == trailing zeros of the OR of
    # all samples; OR-reduce via power-of-two padded folding
    if or_all is None:
        acc = X
        p2 = 1
        while p2 < acc.shape[1]:
            p2 <<= 1
        if p2 != acc.shape[1]:
            acc = xp.pad(acc, [(0, 0), (0, p2 - acc.shape[1])])
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = acc[:, :half] | acc[:, half:]
        or_all = acc[:, 0]
    else:
        or_all = xp.asarray(or_all, dtype=xp.int32)
    low_bit = or_all & (-or_all)
    wasted = xp.where(or_all == 0, 0, popcount32(xp, low_bit - 1))
    wasted = xp.where(const_flag, 0, wasted)        # constants skip it
    Xs = X >> wasted[:, None]

    # ---- FIXED order selection ----------------------------------------
    diffs = [Xs]
    for _ in range(4):
        diffs.append(diffs[-1][:, 1:] - diffs[-1][:, :-1])
    # aligned fixed residuals [S, 5, n] (position i holds diff_o[i-o])
    fixed_res_all = xp.stack(
        [xp.pad(diffs[o], [(0, 0), (o, 0)]) for o in range(5)], axis=1)
    # error sums skip the first 4 positions, so every order competes
    # over the same n-4 values (reference py_encoders/flac.py:449-469)
    # |diff_o| <= 2^(max_bps + 4), so chunk accordingly
    total_error = exact_i32_sum(
        xp, xp.abs(fixed_res_all[:, :, 4:]),
        chunk=sum_chunk_for(max_bps + 4))                  # [S, 5] f64
    # first order o in 0..3 with err[o] < min(err[o+1:]), else 4
    suffix_min = total_error[:, 4]
    conds = []
    for o in range(3, -1, -1):
        conds.append(total_error[:, o] < suffix_min)
        suffix_min = xp.minimum(suffix_min, total_error[:, o])
    conds = xp.stack(conds[::-1], axis=1)                  # [S, 4]
    any_cond = xp.any(conds, axis=1)
    fixed_order = xp.where(any_cond,
                           xp.argmax(conds, axis=1).astype(xp.int32),
                           xp.int32(4))
    if n <= 4:
        fixed_order = xp.zeros(S, dtype=xp.int32)

    fixed_res = xp.take_along_axis(
        fixed_res_all, fixed_order[:, None, None].astype(xp.int32),
        axis=1)[:, 0]                                      # [S, n] i32

    # ---- LPC analysis --------------------------------------------------
    use_lpc = K > 0 and n > K + 1
    if use_lpc:
        with _scope(xp, "flac.autocorr"):
            autocorr = lpc_ops.windowed_autocorr_df(
                xp, Xs, window, K)                   # df pair [S, K+1]
        # hi == 0 implies the exact value is 0 (autocorr values are
        # integer sums scaled by exact powers of two, far above the
        # f32 underflow band)
        degenerate = xp.all(autocorr[0] == 0.0, axis=1)
        with _scope(xp, "flac.levinson"):
            (coeffs, errors) = lpc_ops.levinson_df(xp, autocorr, K)
        with _scope(xp, "flac.quantize"):
            (qlp, shifts) = lpc_ops.quantize_all_orders(
                xp, coeffs, qlp_precision)                 # [S,K,K],[S,K]
        # degenerate rows -> order 1, coeff 0, shift 0
        qlp = xp.where(degenerate[:, None, None], 0, qlp)
        shifts = xp.where(degenerate[:, None], 0, shifts)
        with _scope(xp, "flac.lpc_residuals"):
            lpc_res = lpc_ops.lpc_residuals(
                xp, Xs, qlp, shifts, max_bps, qlp_precision,
                clip_bits=max_bps + 4)                     # [S, K, n]
    else:
        degenerate = xp.ones(S, dtype=bool)
        errors = xp.zeros((S, max(K, 1)), dtype=xp.float64)
        qlp = xp.zeros((S, max(K, 1), max(K, 1)), dtype=xp.int32)
        shifts = xp.zeros((S, max(K, 1)), dtype=xp.int32)
        lpc_res = xp.zeros((S, 0, n), dtype=xp.int32)

    # ---- candidate stack: fixed + K LPC orders ------------------------
    if use_lpc:
        cand_res = xp.concatenate([fixed_res[:, None, :], lpc_res],
                                  axis=1)                  # [S, C, n]
        cand_orders = xp.concatenate(
            [fixed_order[:, None],
             xp.broadcast_to(xp.arange(1, K + 1, dtype=xp.int32),
                             (S, K))], axis=1)             # [S, C]
        C = K + 1
    else:
        cand_res = fixed_res[:, None, :]
        cand_orders = fixed_order[:, None]
        C = 1

    # ---- Rice partition search ----------------------------------------
    # Two spec'd flavors (ref/flac_analysis.rice_search_mode,
    # ATPU_DEVICE_RICE):
    #
    # * "estimate" (default): per-partition |residual| sums at the
    #   finest level (coarser by exact pair-sum), the Rice parameter
    #   from the abs-sum threshold loop, then ONE exact msb sum at
    #   that parameter.  ~1/5 the HBM traffic of the exact ladder;
    #   model ranking/stereo assignment tolerate the estimate because
    #   the FINAL (porder, params) are re-searched exactly on exact
    #   residuals at emit time (hostkernels emit_rice_research).
    # * "exact": every (partition order, partition, parameter) triple
    #   exactly via per-bit-position popcounts w_j over the FINEST
    #   partitions (coarser levels pair-sum; exact descent
    #   sum(u >> r) = 2 * sum(u >> (r+1)) + w_r).  Reference
    #   equivalent: src/encoders/flac.c best_rice_parameters.
    rice_mode = _rice_mode()
    if rice_mode != "exact":
        with _scope(xp, "flac.rice_search"):
            abs_res = xp.abs(cand_res)                     # [S, C, n]
            orders_f = cand_orders.astype(xp.float64)
            pmax = porders[-1]
            parts_max = 1 << pmax

            # |residual| <= 2^(max_bps + 5) (order-4 fixed diffs
            # dominate)
            res_bits = max_bps + 5
            seg_abs_by_p = [None] * (pmax + 1)
            seg_abs_by_p[pmax] = exact_i32_sum(
                xp, xp.reshape(abs_res, (S, C, parts_max, n >> pmax)),
                chunk=sum_chunk_for(res_bits))
            for p in range(pmax - 1, -1, -1):
                fine = seg_abs_by_p[p + 1]
                seg_abs_by_p[p] = fine[:, :, 0::2] + fine[:, :, 1::2]

            rice_totals = []        # per porder: [S, C] f64
            rice_params_by_p = []   # per porder: [S, C, parts] int32
            for porder in porders:
                parts = 1 << porder
                psize = n >> porder
                seg_abs = seg_abs_by_p[porder]             # [S,C,parts]
                counts = xp.full((S, C, parts), float(psize),
                                 dtype=xp.float64)
                counts = _set_first_part(xp, counts,
                                         psize - orders_f)
                # r = min(smallest r with count*2^r >= sum, max_rice)
                r = xp.zeros((S, C, parts), dtype=xp.int32)
                for rr in range(max_rice):
                    r = r + ((counts * float(1 << rr)) <
                             seg_abs).astype(xp.int32)
                # estimated msb bits floor(2 * seg_abs / 2^r): the
                # classic abs-sum Rice size model (sum(u) ~= 2 *
                # sum|res|, sum(u >> r) ~= sum(u) / 2^r).  Closed
                # form over the TINY [S, C, parts] arrays — the
                # per-porder sum(u >> r) passes this replaces
                # re-read the full [S, C, n] zigzag plane seven
                # times, more than the rest of the program.  Model
                # ranking and stereo assignment tolerate the
                # estimate because the FINAL (porder, params) are
                # re-searched exactly on exact residuals at emit
                # time (hostkernels emit_rice_research).  Exact
                # power-of-two scaling keeps the floor
                # backend-deterministic (float-float scales
                # exponents exactly).
                est_msb = xp.floor(
                    seg_abs * 2.0 *
                    lpc_ops.exact_exp2(xp, -r))
                part_bits = 4.0 + est_msb + counts * (
                    1.0 + r.astype(xp.float64))
                rice_totals.append(xp.sum(part_bits, axis=2))
                rice_params_by_p.append(r)
            rice_totals = xp.stack(rice_totals, axis=2)    # [S, C, P]
            best_porder_idx = xp.argmin(rice_totals, axis=2).astype(
                xp.int32)                                  # first min
            rice_bits = xp.min(rice_totals, axis=2)        # [S, C]

            padded_params = xp.stack(
                [xp.pad(p, [(0, 0), (0, 0),
                            (0, parts_max - p.shape[2])])
                 for p in rice_params_by_p], axis=2)   # [S,C,P,maxp]
            chosen_params = xp.take_along_axis(
                padded_params, best_porder_idx[:, :, None, None],
                axis=2)[:, :, 0]                           # [S,C,maxp]
            porder_values = xp.asarray(porders, dtype=xp.int32)
            chosen_porder = porder_values[best_porder_idx] # [S, C]

            method1 = xp.any(chosen_params > 14, axis=2)   # [S, C]
            rice_bits = rice_bits + xp.where(
                method1, _exp2i(xp, chosen_porder), 0.0)
    else:
      with _scope(xp, "flac.rice_search"):
        u = xp.where(cand_res >= 0,
                     cand_res << 1,
                     ((-cand_res - 1) << 1) | 1)               # [S, C, n] i32
        if xp is not np and _ZIGZAG_BARRIER:
            # materialize the zigzag ONCE (ATPU_ZIGZAG_BARRIER=1):
            # the ladder below reads u through ~15 independent
            # reductions and XLA's duplication fusion re-derives the
            # residual chain per consumer.  With the int32
            # recombination in lpc_residuals_i32 the duplicated chain
            # is cheap integer work, so the default leaves fusion
            # alone.
            import jax.lax
            u = jax.lax.optimization_barrier(u)

        orders_f = cand_orders.astype(xp.float64)
        pmax = porders[-1]
        parts_max = 1 << pmax

        # u < 2^(max_bps + 6): order-4 fixed diffs grow 4 bits past
        # the clip bound and the zigzag doubles
        J = max_bps + 7
        R = max_rice + 1
        # Only parameters r in 0..R-1 are ever chosen, and for any r
        # past the point where sum(u >> r) hits 0 the totals are
        # strictly increasing in r (each value contributes at most 1
        # to sum(u >> (J-1)), so totals[J] >= totals[J-1] with
        # first-min ties resolving earlier) — so the search truncates
        # exactly at J0 = min(R-1, J):
        #   * per-bit-plane popcounts w_j only for j < J0, extracted
        #     from uint8 BYTE SPLITS of u (1/4 the HBM traffic of
        #     int32 plane reads; the 24-plane int32 ladder this
        #     replaces was the analysis program's top cost)
        #   * ONE direct partial sum t_top = sum(u >> J0) seeds the
        #     msb descent (values < 2^(J-J0); with psize <= 2^16 the
        #     int32 partials cannot wrap)
        # Identical totals, argmins and parameters by construction.
        J0 = min(R - 1, J)
        R_eff = J0 + 1
        psize_fin = n >> pmax
        u_fin = xp.reshape(u, (S, C, parts_max, psize_fin))
        # all J0 bit-plane counts AND the t_top seed in ONE stacked
        # reduction: plane r < J0 contributes (u >> r) & 1, plane J0
        # contributes u >> J0 (values < 2^(J-J0); psize <= 2^16 keeps
        # int32 partials exact).  A single consumer of u lets XLA
        # fuse the whole residual->zigzag chain into the reduce
        # instead of re-deriving it once per plane (the 16-plane
        # byte-split form this replaces re-derived it through
        # duplication fusion).
        rr = xp.arange(J0 + 1, dtype=xp.int32)
        vals = u_fin[..., None, :] >> rr[:, None]  # [S,C,parts,R',ps]
        contrib = xp.where(rr[:, None] < J0, vals & 1, vals)
        w_fin = xp.sum(contrib, axis=-1,
                       dtype=xp.int32)             # [S,C,parts,J0+1]

        # msb descent ONCE, at the finest level, in native int32
        # when the level's bound psize * 2^J fits:
        #   msb_fin[.., r] = sum over the finest partition of (u >> r)
        # seeded by the direct t_top sum, descending via
        # sum(u >> r) = 2 * sum(u >> (r+1)) + w_r.  msb is ADDITIVE
        # over partition unions, so every coarser level is a plain
        # pair sum (promoted to f64 exactly when its own bound
        # outgrows int32) with NO per-level descent chain — the
        # float-float f64 chains this replaces ran at every level.
        # headroom covers the totals' counts * (1 + r) addend too
        fin_safe = psize_fin * float(2 ** J + R_eff) < 2.0 ** 31
        src = w_fin if fin_safe else w_fin.astype(xp.float64)
        one = 1 if fin_safe else 1.0
        msb_cols = [None] * R_eff
        msb = src[..., J0]
        msb_cols[J0] = msb
        for r in range(J0 - 1, -1, -1):
            msb = msb * (2 * one) + src[..., r]
            msb_cols[r] = msb
        msb_fin = xp.stack(msb_cols, axis=-1)      # [S,C,parts,R']

        msb_levels = [None] * (pmax + 1)
        msb_levels[pmax] = msb_fin
        for p in range(pmax - 1, -1, -1):
            fine = msb_levels[p + 1]
            if (fine.dtype == xp.int32 and
                    (n >> p) * float(2 ** J + R_eff) >= 2.0 ** 31):
                fine = fine.astype(xp.float64)
            msb_levels[p] = fine[:, :, 0::2] + fine[:, :, 1::2]

        rice_totals = []        # per porder: [S, C] f64
        rice_params_by_p = []   # per porder: [S, C, parts] int32
        for porder in porders:
            parts = 1 << porder
            psize = n >> porder
            msb_p = msb_levels[porder]             # [S,C,parts,R']
            if msb_p.dtype == xp.int32:
                # int32 totals: msb < 2^31 by the level bound and
                # counts * (1 + r) adds at most psize * R' << 2^31
                counts = xp.full((S, C, parts), psize,
                                 dtype=xp.int32)
                counts = _set_first_part(
                    xp, counts, (psize - cand_orders).astype(xp.int32))
                rr = xp.arange(1, R_eff + 1, dtype=xp.int32)
                totals = msb_p + counts[..., None] * rr
                r_best = xp.argmin(totals, axis=-1).astype(xp.int32)
                part_bits = 4.0 + xp.min(
                    totals, axis=-1).astype(xp.float64)
            else:
                counts = xp.full((S, C, parts), float(psize),
                                 dtype=xp.float64)
                counts = _set_first_part(xp, counts,
                                         psize - orders_f)
                totals = xp.stack(
                    [msb_p[..., r] + counts * float(1 + r)
                     for r in range(R_eff)], axis=-1)
                r_best = xp.argmin(totals, axis=-1).astype(xp.int32)
                part_bits = 4.0 + xp.min(totals, axis=-1)
            rice_totals.append(xp.sum(part_bits, axis=2))
            rice_params_by_p.append(r_best)
        rice_totals = xp.stack(rice_totals, axis=2)            # [S, C, P]
        best_porder_idx = xp.argmin(rice_totals, axis=2).astype(
            xp.int32)                                          # first min
        rice_bits = xp.min(rice_totals, axis=2)                # [S, C]

        # gather chosen rice params (pad each porder's params to max parts)
        padded_params = xp.stack(
            [xp.pad(p, [(0, 0), (0, 0), (0, parts_max - p.shape[2])])
             for p in rice_params_by_p], axis=2)               # [S,C,P,maxp]
        chosen_params = xp.take_along_axis(
            padded_params, best_porder_idx[:, :, None, None],
            axis=2)[:, :, 0]                                   # [S, C, maxp]
        porder_values = xp.asarray(porders, dtype=xp.int32)
        chosen_porder = porder_values[best_porder_idx]         # [S, C]

        # the search sizes partitions at 4 header bits, but streams whose
        # parameters exceed 14 are written with coding method 1 (5-bit
        # parameters); subframe-level comparisons use actual bits
        method1 = xp.any(chosen_params > 14, axis=2)           # [S, C]
        rice_bits = rice_bits + xp.where(
            method1, _exp2i(xp, chosen_porder), 0.0)


    # ---- candidate subframe sizes -------------------------------------
    wasted_f = wasted.astype(xp.float64)
    wb = 1.0 + xp.where(wasted > 0, wasted_f, 0.0)         # [S]
    ebps = bps_f - wasted_f
    fixed_bits = (1 + 3 + 3 + wb + orders_f[:, 0] * ebps +
                  rice_bits[:, 0] + 2 + 4)
    if use_lpc:
        lpc_orders = orders_f[:, 1:]                       # [S, K]
        lpc_bits = (1 + 1 + 5 + wb[:, None] +
                    lpc_orders * ebps[:, None] +
                    4 + 5 + lpc_orders * qlp_precision +
                    rice_bits[:, 1:] + 2 + 4)              # [S, K]
        if exhaustive:
            lpc_choice = xp.argmin(lpc_bits, axis=1).astype(
                xp.int32)                                  # first min
        else:
            est = lpc_ops.estimate_best_lpc_order(
                xp, errors, n, bps_f, qlp_precision, K)
            est = xp.maximum(est, 1)
            lpc_choice = (est - 1).astype(xp.int32)
        lpc_choice = xp.where(degenerate, 0, lpc_choice)
        lpc_best_bits = xp.take_along_axis(
            lpc_bits, lpc_choice[:, None], axis=1)[:, 0]
        lpc_order_sel = lpc_choice + 1                     # [S] int32
    else:
        lpc_best_bits = xp.full(S, 1e30, dtype=xp.float64)
        lpc_choice = xp.zeros(S, dtype=xp.int32)
        lpc_order_sel = xp.ones(S, dtype=xp.int32)

    verbatim_estimate = bps_f * n
    verbatim_actual = 1 + 6 + wb + ebps * n
    min_coded = xp.minimum(fixed_bits, lpc_best_bits)

    choice = xp.where(
        const_flag, CHOICE_CONSTANT,
        xp.where(verbatim_estimate < min_coded, CHOICE_VERBATIM,
                 xp.where(fixed_bits < lpc_best_bits,
                          CHOICE_FIXED, CHOICE_LPC))).astype(xp.int32)

    sub_bits = xp.where(
        choice == CHOICE_CONSTANT,
        8.0 + bps_f,
        xp.where(choice == CHOICE_VERBATIM, verbatim_actual,
                 xp.where(choice == CHOICE_FIXED, fixed_bits,
                          lpc_best_bits)))

    # ---- gather chosen candidate data ---------------------------------
    cand_idx = xp.where(choice == CHOICE_LPC,
                        1 + lpc_choice, 0).astype(xp.int32)  # [S]
    chosen_res = xp.take_along_axis(
        cand_res, cand_idx[:, None, None], axis=1)[:, 0]
    chosen_order = xp.where(
        choice == CHOICE_LPC, lpc_order_sel,
        cand_orders[:, 0]).astype(xp.int32)
    chosen_rice = xp.take_along_axis(
        chosen_params, cand_idx[:, None, None], axis=1)[:, 0]
    chosen_porder2 = xp.take_along_axis(
        chosen_porder, cand_idx[:, None], axis=1)[:, 0]
    if use_lpc:
        qlp_row = xp.maximum(lpc_order_sel - 1, 0).astype(xp.int32)
        chosen_qlp = xp.take_along_axis(
            qlp, qlp_row[:, None, None], axis=1)[:, 0]
        chosen_shift = xp.take_along_axis(
            shifts, qlp_row[:, None], axis=1)[:, 0]
    else:
        chosen_qlp = qlp[:, 0]
        chosen_shift = shifts[:, 0]

    return {
        "choice": choice,
        "wasted": wasted.astype(xp.int32),
        "const_val": const_val.astype(xp.int32),
        "order": chosen_order,
        "porder": chosen_porder2.astype(xp.int32),
        "rice_params": chosen_rice.astype(xp.int32),
        "residual": chosen_res.astype(xp.int32),
        "qlp": chosen_qlp.astype(xp.int32),
        "shift": chosen_shift.astype(xp.int32),
        "samples": Xs.astype(xp.int32),
        "sub_bits": sub_bits,
    }


def _set_first_part(xp, counts, first_values):
    """sets counts[:, :, 0] = first_values"""
    if xp is np:
        counts[:, :, 0] = first_values
        return counts
    else:
        return counts.at[:, :, 0].set(first_values)


def choose_assignment(xp, lb, rb, ab, db, mid_side):
    """the reference's stereo assignment chain
    (py_encoders/flac.py:196-226); inputs are per-frame bit totals

    returns assignment codes [B] int32: 1 (L/R), 8 (L/S), 9 (S/R),
    10 (M/S)
    """
    lr = lb + rb
    if mid_side:
        take_lr = lr < xp.minimum(xp.minimum(lb + db, db + rb), ab + db)
        take_ls = lb < xp.minimum(rb, db)
        take_sr = rb < ab
        out = xp.where(take_lr, 1,
                       xp.where(take_ls, 8,
                                xp.where(take_sr, 9, 10)))
    else:
        out = xp.where(lr < (ab + db), 1, 10)
    return out.astype(xp.int32)


# variant index pairs per stereo assignment: (subframe0, subframe1)
# variants are ordered [left, right, average, difference]
ASSIGNMENT_VARIANTS = {1: (0, 1), 8: (0, 3), 9: (3, 1), 10: (2, 3)}


def analyze_frames_packed(xp, blocks, stereo_trial, bps, n,
                          max_lpc_order, qlp_precision, porders,
                          max_rice, exhaustive, mid_side, window,
                          or_vals=None, const_flags=None,
                          return_chosen=False):
    """full per-frame analysis: variants, subframe trials, channel
    assignment, and decision packing — one device round trip per batch

    blocks: int [B, n, ch]; returns packed int32
    [B, 1 + max_subframes * W]: column 0 is the FLAC channel
    assignment, then per chosen subframe the layout documented at the
    top of this module (W = packed_width(K, 1 << porders[-1])).

    or_vals / const_flags: optional [B, V] exactness sideband (variant
    order matching build_variants); required whenever blocks carry
    quantized samples (ops/qpack.py)."""
    B = blocks.shape[0]
    ch = blocks.shape[2]
    K = max_lpc_order
    P = 1 << porders[-1]

    (X, bps_vec) = build_variants(xp, blocks, stereo_trial, bps)
    Vn = 4 if stereo_trial else ch
    or_flat = (None if or_vals is None
               else xp.reshape(xp.asarray(or_vals, dtype=xp.int32),
                               (B * Vn,)))
    const_flat = (None if const_flags is None
                  else xp.reshape(xp.asarray(const_flags), (B * Vn,)))
    out = analyze_subframes(xp, X, bps_vec, n, K, qlp_precision,
                            list(porders), max_rice, exhaustive, window,
                            or_all=or_flat, const_flag=const_flat,
                            max_bps=bps + 1 if stereo_trial else bps)

    V = 4 if stereo_trial else ch
    sub_bits = xp.reshape(out["sub_bits"], (B, V))
    if stereo_trial:
        a = choose_assignment(xp, sub_bits[:, 0], sub_bits[:, 1],
                              sub_bits[:, 2], sub_bits[:, 3], mid_side)
        # variant pair per assignment code (see ASSIGNMENT_VARIANTS)
        var0 = xp.where(a == 9, 3, xp.where(a == 10, 2, 0))
        var1 = xp.where(a == 1, 1, xp.where(a == 9, 1, 3))
        pairs = xp.stack([var0, var1], axis=1)             # [B, 2]
        max_subframes = 2
    else:
        a = xp.full((B,), ch - 1, dtype=xp.int32)
        pairs = xp.broadcast_to(xp.arange(V, dtype=xp.int32), (B, V))
        max_subframes = V

    def gather(name, extra):
        arr = xp.reshape(out[name], (B, V) + extra)
        idx = xp.reshape(pairs, (B, max_subframes) + (1,) * len(extra))
        idx = idx.astype(xp.int32)
        return xp.take_along_axis(arr, idx, axis=1)

    scalars = xp.stack([
        gather("choice", ()),
        gather("wasted", ()),
        gather("order", ()),
        gather("porder", ()),
        gather("shift", ()),
        xp.take_along_axis(sub_bits, pairs.astype(xp.int32),
                           axis=1).astype(xp.int32),
    ], axis=2)                                  # [B, max_subframes, 6]
    qlp = gather("qlp", (out["qlp"].shape[-1],))
    Kp = max(K, 1)
    if qlp.shape[-1] != Kp:                     # normalize to K wide
        qlp = xp.pad(qlp, [(0, 0), (0, 0), (0, Kp - qlp.shape[-1])])
    rice = gather("rice_params", (out["rice_params"].shape[-1],))
    if rice.shape[-1] != P:
        rice = xp.pad(rice, [(0, 0), (0, 0), (0, P - rice.shape[-1])])

    per_sub = xp.concatenate([scalars, qlp, rice],
                             axis=2)            # [B, max_subframes, W]
    flat = xp.reshape(per_sub, (B, max_subframes * per_sub.shape[2]))
    packed = xp.concatenate([a[:, None], flat],
                            axis=1).astype(xp.int32)
    if not return_chosen:
        return packed
    # the chosen subframes' analysis data, for device-side residual
    # packing (ops/pallas_bitpack.py): same gather as the decision
    # rows, so the packed bits always match the decisions they ride
    # with
    chosen = {
        "residual": gather("residual", (n,)),  # [B, max_sub, n]
        "choice": gather("choice", ()),
        "order": gather("order", ()),
        "porder": gather("porder", ()),
        "rice_params": rice,                   # [B, max_sub, P]
        "max_subframes": max_subframes,
    }
    return (packed, chosen)
