"""Cross-backend byte-determinism of the analysis kernels.

The encode analysis spec (ops/lpc.py, ops/flac_frames.py,
ops/alac_frames.py) promises bit-identical decisions from numpy, CPU
XLA and accelerator XLA — including float-float f64 emulation, whose
non-IEEE rounding (inexact ``exp2`` of integral args, ~49-bit add
chains, approximate division) historically diverged from numpy at the
±1-bit level in subframe size totals and flipped argmin decisions
(regression: long noisy streams encoded to different — still lossless
— bytes per backend).

These tests drive the full fast encoders on both backends over inputs
long and noisy enough to hit rounding boundaries (the tiny smoke
inputs in test_qpack.py never did) and require byte equality.
Mirrors the reference's C-vs-Python codec equivalence strategy
(/root/reference/test/test_formats.py:4075-4130) one level down: fast
backend vs fast backend.
"""

import io

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
from audiotools_tpu.codecs.alac_fast import encode_mdat_fast
from audiotools_tpu.pcmstream import PCMReader


def noisy_reader(bps=16, seconds=12, seed=7):
    rng = np.random.default_rng(seed)
    n = 44100 * seconds
    t = np.arange(n)
    amp = 1 << (bps - 3)
    sig = (amp * np.sin(2 * np.pi * 440 * t / 44100) +
           rng.integers(-amp // 8, amp // 8, n)).astype(np.int64)
    arr = np.stack([sig, np.roll(sig, 311)], 1).astype(np.int32)
    fl = pcm.FrameList._wrap(arr, bps)
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                     44100, 2, 3, bps)


def encode_both(make_reader, **opts):
    outs = {}
    for backend in ("numpy", "jax"):
        buf = io.BytesIO()
        encode_flac_fast(buf, make_reader(), backend=backend, **opts)
        outs[backend] = buf.getvalue()
    return outs


# default run keeps a SHORT representative of each family (the long
# 12 s streams take minutes each on a 1-core box and sat silent in
# the default suite); the full-length variants are the slow battery
@pytest.mark.parametrize(
    "exhaustive,seconds",
    [pytest.param(False, 12, marks=pytest.mark.slow),
     pytest.param(True, 12, marks=pytest.mark.slow),
     # 1 s = 44 blocks pads to the same 64-row jit shape the rest of
     # the suite compiles, so the default run reuses the XLA program
     (True, 1)])
def test_flac8_long_noisy_byte_identity(exhaustive, seconds):
    outs = encode_both(
        lambda: noisy_reader(seconds=seconds),
        max_lpc_order=12, max_residual_partition_order=6,
        mid_side=True, exhaustive_model_search=exhaustive)
    assert outs["numpy"] == outs["jax"]


@pytest.mark.slow
def test_flac_24bit_byte_identity():
    outs = encode_both(
        lambda: noisy_reader(bps=24, seconds=6),
        max_lpc_order=12, max_residual_partition_order=6,
        mid_side=True, exhaustive_model_search=True)
    assert outs["numpy"] == outs["jax"]


@pytest.mark.parametrize(
    "seconds", [pytest.param(6, marks=pytest.mark.slow), 2])
def test_alac_long_noisy_byte_identity(seconds):
    outs = {}
    for backend in ("numpy", "jax"):
        buf = io.BytesIO()
        encode_mdat_fast(buf, noisy_reader(seconds=seconds),
                         backend=backend)
        outs[backend] = buf.getvalue()
    assert outs["numpy"] == outs["jax"]


def test_flac_24bit_short_byte_identity():
    """fast default-run representative of the slow 24-bit battery
    (covers the int32-wrap residual path on both backends)"""
    outs = encode_both(
        lambda: noisy_reader(bps=24, seconds=1),
        max_lpc_order=12, max_residual_partition_order=6,
        mid_side=True, exhaustive_model_search=True)
    assert outs["numpy"] == outs["jax"]
