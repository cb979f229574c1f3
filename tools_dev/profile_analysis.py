#!/usr/bin/env python
"""Attributes the FLAC -8 device analysis program's cost stage by stage.

Builds a ladder of jitted programs, each adding one analysis stage
(variants/wasted/fixed -> autocorr_df -> levinson+quantize ->
lpc_residuals -> zigzag -> popcount ladder -> exact rice search ->
full packed program), and times each steady-state on the real device.
The per-stage cost is the successive difference (the dispatch floor
is measured with a trivial program and reported separately).

Usage:  python tools_dev/profile_analysis.py [batch_blocks]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_compilation_cache_dir",
                  os.path.expanduser("~/.cache/atpu/jaxcache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from audiotools_tpu.ops import flac_frames, lpc as lpc_ops

BATCH = int(sys.argv[1]) if len(sys.argv) > 1 else 512
N = 4096
K = 12
PRECISION = 14
BPS = 16
MAX_RICE = 14
PORDERS = list(range(7))

rng = np.random.default_rng(7)
t = np.arange(BATCH * N)
left = (9000 * np.sin(2 * np.pi * 441 * t / 44100) +
        4000 * np.sin(2 * np.pi * 881 * t / 44100))
right = (8000 * np.sin(2 * np.pi * 599 * t / 44100 + 0.4))
sig = np.stack([left, right], axis=1) + rng.normal(0, 600,
                                                   (BATCH * N, 2))
blocks_np = np.clip(sig, -32768, 32767).astype(np.int32).reshape(
    BATCH, N, 2)

window = lpc_ops.tukey_window_df(N)

dev = jax.devices()[0]
blocks = jax.device_put(blocks_np, dev)
window_d = jax.device_put(window, dev)
jax.block_until_ready(blocks)


def bench(fn, *args, iters=6):
    # device_get waits for the program and fetches its result
    jax.device_get(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.device_get(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times)


def reduce_all(*arrs):
    tot = jnp.float32(0)
    for a in arrs:
        tot = tot + jnp.sum(a.astype(jnp.float32))
    return tot


# --- stage ladder ----------------------------------------------------

def prelude(blocks):
    (X, bps_vec) = flac_frames.build_variants(jnp, blocks, True, BPS)
    X = X.astype(jnp.int32)
    acc = X
    p2 = 1
    while p2 < acc.shape[1]:
        p2 <<= 1
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] | acc[:, half:]
    or_all = acc[:, 0]
    low_bit = or_all & (-or_all)
    wasted = jnp.where(or_all == 0, 0,
                       flac_frames.popcount32(jnp, low_bit - 1))
    Xs = X >> wasted[:, None]
    return Xs, bps_vec, wasted


def fixed_stage(Xs):
    diffs = [Xs]
    for _ in range(4):
        diffs.append(diffs[-1][:, 1:] - diffs[-1][:, :-1])
    fixed_res_all = jnp.stack(
        [jnp.pad(diffs[o], [(0, 0), (o, 0)]) for o in range(5)], axis=1)
    total_error = flac_frames.exact_i32_sum(
        jnp, jnp.abs(fixed_res_all[:, :, 4:]),
        chunk=flac_frames.sum_chunk_for(17 + 4))
    return fixed_res_all, total_error


@jax.jit
def p0(blocks, window):
    Xs, bps_vec, wasted = prelude(blocks)
    fra, te = fixed_stage(Xs)
    return reduce_all(te, wasted)


@jax.jit
def p1(blocks, window):
    Xs, bps_vec, wasted = prelude(blocks)
    fra, te = fixed_stage(Xs)
    ac = lpc_ops.windowed_autocorr_df(jnp, Xs, window, K)
    return reduce_all(te, ac[0], ac[1])


@jax.jit
def p2(blocks, window):
    Xs, bps_vec, wasted = prelude(blocks)
    fra, te = fixed_stage(Xs)
    ac = lpc_ops.windowed_autocorr_df(jnp, Xs, window, K)
    (coeffs, errors) = lpc_ops.levinson_df(jnp, ac, K)
    (qlp, shifts) = lpc_ops.quantize_all_orders(jnp, coeffs, PRECISION)
    return reduce_all(te, qlp, shifts, errors)


@jax.jit
def p3(blocks, window):
    Xs, bps_vec, wasted = prelude(blocks)
    fra, te = fixed_stage(Xs)
    ac = lpc_ops.windowed_autocorr_df(jnp, Xs, window, K)
    (coeffs, errors) = lpc_ops.levinson_df(jnp, ac, K)
    (qlp, shifts) = lpc_ops.quantize_all_orders(jnp, coeffs, PRECISION)
    lpc_res = lpc_ops.lpc_residuals(jnp, Xs, qlp, shifts, 17,
                                    PRECISION, clip_bits=21)
    return reduce_all(te, lpc_res[:, :, ::64])


def candidates(blocks, window):
    Xs, bps_vec, wasted = prelude(blocks)
    fra, te = fixed_stage(Xs)
    ac = lpc_ops.windowed_autocorr_df(jnp, Xs, window, K)
    (coeffs, errors) = lpc_ops.levinson_df(jnp, ac, K)
    (qlp, shifts) = lpc_ops.quantize_all_orders(jnp, coeffs, PRECISION)
    lpc_res = lpc_ops.lpc_residuals(jnp, Xs, qlp, shifts, 17,
                                    PRECISION, clip_bits=21)
    fixed_res = fra[:, 2]    # stand-in gather: any one order
    cand = jnp.concatenate([fixed_res[:, None, :], lpc_res], axis=1)
    return cand


@jax.jit
def p4(blocks, window):
    cand = candidates(blocks, window)
    u = jnp.where(cand >= 0, cand << 1, ((-cand - 1) << 1) | 1)
    return reduce_all(u[:, :, ::64])


@jax.jit
def p5(blocks, window):
    cand = candidates(blocks, window)
    u = jnp.where(cand >= 0, cand << 1, ((-cand - 1) << 1) | 1)
    S, C = u.shape[0], u.shape[1]
    pmax = PORDERS[-1]
    parts_max = 1 << pmax
    J = 17 + 7
    u_fin = jnp.reshape(u, (S, C, parts_max, N >> pmax))
    w_fin = jnp.stack(
        [jnp.sum((u_fin >> j) & 1, axis=-1).astype(jnp.int32)
         for j in range(J)], axis=-1)
    return reduce_all(w_fin)


@jax.jit
def p6(blocks, window):
    """full exact rice search on top of the ladder"""
    cand = candidates(blocks, window)
    u = jnp.where(cand >= 0, cand << 1, ((-cand - 1) << 1) | 1)
    S, C = u.shape[0], u.shape[1]
    pmax = PORDERS[-1]
    parts_max = 1 << pmax
    J = 17 + 7
    u_fin = jnp.reshape(u, (S, C, parts_max, N >> pmax))
    w_fin = jnp.stack(
        [jnp.sum((u_fin >> j) & 1, axis=-1).astype(jnp.int32)
         for j in range(J)], axis=-1)
    w_levels = [None] * (pmax + 1)
    w_levels[pmax] = w_fin
    for p in range(pmax - 1, -1, -1):
        fine = w_levels[p + 1]
        w_levels[p] = fine[:, :, 0::2] + fine[:, :, 1::2]
    R = MAX_RICE + 1
    acc = jnp.float32(0)
    for porder in PORDERS:
        psize = N >> porder
        wf = w_levels[porder].astype(jnp.float64)
        counts = jnp.full(wf.shape[:3], float(psize), dtype=jnp.float64)
        zero = jnp.zeros_like(wf[..., 0])
        msb_by_r = [zero] * max(R, J)
        msb = wf[..., J - 1]
        msb_by_r[J - 1] = msb
        for r in range(J - 2, -1, -1):
            msb = msb * 2.0 + wf[..., r]
            msb_by_r[r] = msb
        totals = jnp.stack(
            [msb_by_r[r] + counts * float(1 + r) for r in range(R)],
            axis=-1)
        r_best = jnp.argmin(totals, axis=-1).astype(jnp.int32)
        part_bits = 4.0 + jnp.min(totals, axis=-1)
        acc = acc + reduce_all(r_best, jnp.sum(part_bits, axis=2))
    return acc


@jax.jit
def full(blocks, window):
    packed = flac_frames.analyze_frames_packed(
        jnp, blocks, True, BPS, N, K, PRECISION, PORDERS, MAX_RICE,
        True, True, window)
    return flac_frames.compact_decisions(jnp, packed, 2, K,
                                         1 << PORDERS[-1]).ravel()


@jax.jit
def trivial(blocks, window):
    return jnp.sum(blocks[:, ::512, :].astype(jnp.float32))


stages = [
    ("rtt floor (trivial)", trivial),
    ("p0 variants+wasted+fixed", p0),
    ("p1 + autocorr_df", p1),
    ("p2 + levinson+quantize", p2),
    ("p3 + lpc_residuals", p3),
    ("p4 + zigzag", p4),
    ("p5 + popcount ladder", p5),
    ("p6 + exact rice search", p6),
    ("full packed program", full),
]

print("batch=%d blocks (%.1f s audio), device=%s" %
      (BATCH, BATCH * N / 44100.0, dev))
only = os.environ.get("ATPU_PROF_ONLY", "")
prev = None
for name, fn in stages:
    if only and only not in name:
        continue
    t0 = time.perf_counter()
    dt = bench(fn, blocks, window_d)
    compile_s = time.perf_counter() - t0
    delta = "" if prev is None else "  (+%6.1f ms)" % (
        (dt - prev) * 1e3)
    print("%-28s %8.1f ms%s   [warmup %.0fs]" %
          (name, dt * 1e3, delta, compile_s), flush=True)
    if name.startswith("p") or name.startswith("full"):
        prev = dt
