#!/usr/bin/env python
"""Host-stage profiler for the FLAC encode pipeline.

Times each host stage of the batched encoder on one steady-state
batch (default 256 blocks x 4096 x 2ch of bench.py program material):
read/unpack, qpack scan (+fused MD5), emit, and the pure-MD5 cost,
so optimization work targets measured numbers instead of guesses.

Usage: python tools/profile_host.py [--batch 256] [--trials 5]
"""

import argparse
import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from audiotools_tpu import _native, pcm
from audiotools_tpu.pcmstream import PCMReader, BufferedPCMReader
from audiotools_tpu.ops import flac_frames, lpc as lpc_ops


def make_signal(n_frames, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    sr = 44100
    left = (9000 * np.sin(2 * np.pi * 441 * t / sr) +
            4000 * np.sin(2 * np.pi * 881 * t / sr) +
            2000 * np.sin(2 * np.pi * 0.25 * t / sr) *
            np.sin(2 * np.pi * 1327 * t / sr))
    right = (8000 * np.sin(2 * np.pi * 599 * t / sr + 0.4) +
             3000 * np.sin(2 * np.pi * 1201 * t / sr))
    noise = rng.normal(0, 600, (n_frames, 2))
    out = np.stack([left, right], axis=1) + noise
    return np.clip(out, -32768, 32767).astype(np.int32)


def timeit(fn, trials):
    best = None
    for _ in range(trials):
        t0 = time.perf_counter()
        result = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None or dt < best else best
    return (best, result)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()

    B, n = args.batch, args.block
    arr = make_signal(B * n)
    nsamples = arr.size
    blocks = np.ascontiguousarray(arr.reshape(B, n, 2))
    fl = pcm.FrameList._wrap(arr, 16)
    raw = fl.to_bytes(False, True)

    def report(name, dt, extra=""):
        print("%-28s %8.2f ms   %7.1f Msamples/s  %s" %
              (name, dt * 1e3, nsamples / dt / 1e6, extra))

    # ---- read path: BufferedPCMReader.read of the full batch ----
    def do_read():
        r = BufferedPCMReader(PCMReader(io.BytesIO(raw), 44100, 2, 3, 16))
        return r.read(B * n)
    (dt, _) = timeit(do_read, args.trials)
    report("read+unpack (PCMReader)", dt)

    # ---- MD5 alone ----
    def do_md5():
        md5 = _native.MD5()
        md5.update_pcm(arr, 16)
        return md5.digest()
    (dt, _) = timeit(do_md5, args.trials)
    report("MD5 (fused pcm)", dt)

    # ---- qpack scan without MD5 ----
    (dt, q) = timeit(lambda: _native.flac_qpack(blocks, 16, 0, True),
                     args.trials)
    report("qpack scan (no md5)", dt,
           "k=%d wire=%.2f MB" % (q[1], q[0].nbytes / 1e6))

    # ---- qpack scan with fused MD5 ----
    def do_qpack_md5():
        md5 = _native.MD5()
        return _native.flac_qpack(blocks, 16, 0, True, md5=md5)
    (dt, _) = timeit(do_qpack_md5, args.trials)
    report("qpack scan (+fused md5)", dt)

    # ---- numpy analysis (for a decision array to feed the emitter;
    #       also the host-backend analysis cost) ----
    porders = flac_frames.valid_partition_orders(n, 6, 12)
    window = lpc_ops.tukey_window(n)
    (dt, packed) = timeit(
        lambda: flac_frames.analyze_frames_packed(
            np, blocks, True, 16, n, 12, 15, porders, 14, True, True,
            window),
        1)
    report("numpy analysis (1 trial)", dt)
    packed = np.ascontiguousarray(packed)

    # ---- emit ----
    Kp, P = 12, 1 << porders[-1]
    fnums = np.arange(B, dtype=np.int64)
    bsizes = np.full(B, n, dtype=np.int32)
    (dt, out) = timeit(
        lambda: _native.flac_emit_frames2(
            blocks, fnums, bsizes, packed, 2, Kp, P, 44100, 16, 2, 15),
        args.trials)
    report("emit (C++)", dt,
           "out=%.2f MB" % (len(out[0]) / 1e6,))

    total_ms = 0.0
    print()
    print("batch = %d x %d x 2 = %.2f Msamples (%.3f s audio)" %
          (B, n, nsamples / 1e6, B * n / 44100.0))


if __name__ == "__main__":
    main()
