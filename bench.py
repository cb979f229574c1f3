#!/usr/bin/env python
"""Benchmark: FLAC -8 encode throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "trial_secs": [...]}

metric: PCM Msamples/sec for bit-exact FLAC -8 encode of 44.1 kHz
stereo (the BASELINE.md north-star config).  The platform, the device
kind and the card's name and power limit go to stderr.

The bench encodes synthetic stereo program material with the batched
encoder (JAX backend on the default device), then decode-verifies the
output bit-exactly before reporting.  It exits non-zero, timing
nothing, when JAX's device is not a GPU.  There is NO silent fallback:
if the JAX device path fails, the bench reports 0 — a regression in
the production path must fail loudly, not degrade to the host path.
"""

import io
import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
from audiotools_tpu import _native

SAMPLE_RATE = 44100
BLOCK = 4096
# 1024-block batches: the encoder's default batch on the jax backend
BATCH = int(os.environ.get("ATPU_BENCH_BATCH", "1024"))
# 16 batches (12.7 min of audio) amortize the pipeline's fill and
# drain the way an album-length encode does
N_BATCHES = int(os.environ.get("ATPU_BENCH_BATCHES", "16"))
OPTS = dict(block_size=BLOCK, max_lpc_order=12, mid_side=True,
            exhaustive_model_search=True,
            max_residual_partition_order=6,
            batch_frames=BATCH)


def make_signal(n_frames, seed=7):
    """synthetic stereo program material (tonal + noise mix)"""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    left = (9000 * np.sin(2 * np.pi * 441 * t / SAMPLE_RATE) +
            4000 * np.sin(2 * np.pi * 881 * t / SAMPLE_RATE) +
            2000 * np.sin(2 * np.pi * 0.25 * t / SAMPLE_RATE) *
            np.sin(2 * np.pi * 1327 * t / SAMPLE_RATE))
    right = (8000 * np.sin(2 * np.pi * 599 * t / SAMPLE_RATE + 0.4) +
             3000 * np.sin(2 * np.pi * 1201 * t / SAMPLE_RATE))
    noise = rng.normal(0, 600, (n_frames, 2))
    out = np.stack([left, right], axis=1) + noise
    return np.clip(out, -32768, 32767).astype(np.int32)


def reader_for(arr):
    fl = pcm.FrameList._wrap(arr, 16)
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                     SAMPLE_RATE, 2, 3, 16)


def reader_for_bytes(data):
    """PCMReader over pre-rendered little-endian PCM bytes (the input
    'file' is prepared outside the timed region, like a disk cache)"""
    return PCMReader(io.BytesIO(data), SAMPLE_RATE, 2, 3, 16)


class Timeout(Exception):
    pass


def _alarm(signum, frame):
    raise Timeout()


def run_encode(pcm_bytes, backend):
    """times one encode: pre-rendered input bytes -> tmpfs output file

    a real (tmpfs) output file avoids the BytesIO realloc cascade —
    every multi-MB write into a growing BytesIO re-copies the buffer,
    which is pure bench-harness CPU"""
    import tempfile
    outdir = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.NamedTemporaryFile(dir=outdir, suffix=".flac") as f:
        t0 = time.time()
        encode_flac_fast(f, reader_for_bytes(pcm_bytes),
                         backend=backend, **OPTS)
        f.flush()
        dt = time.time() - t0
        f.seek(0)
        return (f.read(), dt)


def verify(data, arr):
    """decode-verify the encoded stream bit-exactly"""
    from audiotools_tpu.bitstream import BitstreamReader
    r = BitstreamReader(data, False)
    r.skip_bytes(4)
    last = 0
    while last != 1:
        (last, _btype, blen) = r.parse("1u 7u 24u")
        r.skip_bytes(blen)
    offset = r.source.tell()
    (samples, _consumed) = _native.flac_decode(
        data[offset:], 16, 2, len(arr))
    return np.array_equal(samples, arr)


def describe_device():
    """platform, device kind and the card's name and power limit (on
    stderr); returns the JAX device, or None when it is not a GPU"""
    import subprocess
    import jax

    dev = jax.devices()[0]
    print("platform=%s kind=%s count=%d" %
          (dev.platform, dev.device_kind, len(jax.devices())),
          file=sys.stderr)
    if dev.platform != "gpu":
        return None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print("card: %s" % card.stdout.strip(), file=sys.stderr)
    return dev


def main():
    if describe_device() is None:
        print("bench: JAX's device is not a GPU; nothing was timed",
              file=sys.stderr)
        return 1
    warm = make_signal(BLOCK * BATCH)           # one full batch
    arr = make_signal(BLOCK * BATCH * N_BATCHES)
    # the input "file" bytes are rendered once, outside the timing
    warm_bytes = pcm.FrameList._wrap(warm, 16).to_bytes(False, True)
    arr_bytes = pcm.FrameList._wrap(arr, 16).to_bytes(False, True)

    # no fallback chain: the production (JAX device) path must work
    backend = os.environ.get("ATPU_FLAC_BACKEND", "jax")
    try:
        timeout = int(os.environ.get("ATPU_BENCH_TIMEOUT", "1500"))
        signal.signal(signal.SIGALRM, _alarm)
        signal.alarm(timeout)
        run_encode(warm_bytes, backend)         # jit compile + caches
        signal.alarm(0)
        best = None
        trial_secs = []
        for _trial in range(int(os.environ.get("ATPU_BENCH_TRIALS",
                                               "6"))):
            (data, dt) = run_encode(arr_bytes, backend)
            trial_secs.append(round(dt, 3))
            if best is None or dt < best[1]:
                best = (data, dt)
        (data, dt) = best
    except (Timeout, Exception) as err:  # noqa: B902
        signal.alarm(0)
        print("backend %s failed: %r" % (backend, err),
              file=sys.stderr)
        print(json.dumps({"metric": "flac8_encode_Msamples_per_sec",
                          "value": 0.0, "unit": "Msamples/s"}))
        return 1

    n_frames = arr.shape[0]
    bit_exact = verify(data, arr)
    msamples = (n_frames * 2) / dt / 1e6        # samples incl. channels
    realtime = (n_frames / SAMPLE_RATE) / dt
    ratio = len(data) / (arr.size * 2)

    print("backend=%s %.1fs audio in %.2fs | %.1f Msamples/s | "
          "%.0fx realtime | ratio %.3f | bit_exact=%s" %
          (backend, n_frames / SAMPLE_RATE, dt, msamples, realtime,
           ratio, bit_exact), file=sys.stderr)

    print(json.dumps({
        "metric": "flac8_encode_Msamples_per_sec",
        "value": round(msamples if bit_exact else 0.0, 3),
        "unit": "Msamples/s",
        "trial_secs": trial_secs,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
