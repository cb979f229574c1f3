#!/usr/bin/env python
"""Measures the DEVICE FLAC decode path end-to-end (a 30 s -8 stereo
file, wall-clock realtime-x, byte-exact vs the host decoder).

Usage: python tools_dev/bench_decode_device.py [seconds] [trials]
"""

import io
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from bench_all import make_signal, reader_for, SR
from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
from audiotools_tpu.codecs import flac_dec_jax

SECONDS = int(sys.argv[1]) if len(sys.argv) > 1 else 30
TRIALS = int(sys.argv[2]) if len(sys.argv) > 2 else 4

arr = make_signal(SR * SECONDS)
buf = io.BytesIO()
encode_flac_fast(buf, reader_for(arr), max_lpc_order=12,
                 max_residual_partition_order=6, mid_side=True,
                 exhaustive_model_search=True, backend="numpy")
data = buf.getvalue()
print("encoded %d s -> %.2f MB" % (SECONDS, len(data) / 1e6),
      flush=True)


def decode_all():
    dec = flac_dec_jax.JaxFlacDecoder(io.BytesIO(data))
    out = []
    fl = dec.read(1 << 18)
    while fl.frames:
        out.append(fl.samples)
        fl = dec.read(1 << 18)
    return np.concatenate(out)


t0 = time.perf_counter()
first = decode_all()
print("first decode (compiles): %.2f s" % (time.perf_counter() - t0),
      flush=True)
assert np.array_equal(first, arr), "device decode mismatch"

best = None
for _ in range(TRIALS):
    t0 = time.perf_counter()
    got = decode_all()
    dt = time.perf_counter() - t0
    best = dt if best is None else min(best, dt)
assert np.array_equal(got, arr)
ms = SECONDS * SR * 2 / best / 1e6
print("device decode: %.2f s for %d s audio -> %.1fx realtime, "
      "%.2f Msamples/s (byte-exact)" %
      (best, SECONDS, SECONDS / best, ms))
