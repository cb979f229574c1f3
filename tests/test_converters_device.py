"""Device converter suite vs host kernels (ops/converters.py).

The north-star device converter trio: Resampler FIR, ReplayGain
equal-loudness analysis, AccurateRip MACs — each env-gated device
backend must match its host kernel (bit-identical for AccurateRip's
integer lattice; within float tolerance for the float pipelines).
Runs on the CPU JAX backend (conftest), same jitted programs as the GPU.
"""

import io

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu.ops import converters


def _reader(arr, rate, bps=16):
    fl = pcm.FrameList._wrap(arr.astype(np.int32), bps)
    ch = arr.shape[1]
    mask = {1: 0x4, 2: 0x3}[ch]
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                     rate, ch, mask, bps)


def _signal(n, rate, seed=0, ch=2, amp=9000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = (amp * np.sin(2 * np.pi * 441 * t / rate) +
            amp / 3 * np.sin(2 * np.pi * 1321 * t / rate))
    out = np.stack([base * (0.8 + 0.2 * c) for c in range(ch)], axis=1)
    out += rng.normal(0, amp / 20, out.shape)
    return np.clip(out, -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# AccurateRip


def test_accuraterip_device_bit_identical(monkeypatch):
    from audiotools_tpu.accuraterip_checksum import (
        AccurateRipCRC, ChecksumV1, ChecksumV2)

    arr = _signal(44100 * 2 + 1234, 44100, seed=3)
    n = arr.shape[0]

    host = AccurateRipCRC(True, True, 44100, n)
    for off in range(0, n, 65536):
        host.update_array(arr[off:off + 65536])
    (h1, h2) = host.checksums()

    monkeypatch.setenv("ATPU_AR_BACKEND", "jax")
    dev = AccurateRipCRC(True, True, 44100, n)
    for off in range(0, n, 65536):
        dev.update_array(arr[off:off + 65536])
    (d1, d2) = dev.checksums()

    assert (d1, d2) == (h1, h2)

    # and both equal the scalar NumPy oracles
    v1 = ChecksumV1(True, True, 44100, n)
    v2 = ChecksumV2(True, True, 44100, n)
    fl = pcm.FrameList._wrap(arr, 16)
    v1.update(fl)
    v2.update(fl)
    assert d1 == v1.checksum()
    assert d2 == v2.checksum()


def test_accuraterip_device_middle_track(monkeypatch):
    from audiotools_tpu.accuraterip_checksum import AccurateRipCRC

    arr = _signal(44100, 44100, seed=9)
    n = arr.shape[0]
    host = AccurateRipCRC(False, False, 44100, n)
    host.update_array(arr)
    monkeypatch.setenv("ATPU_AR_BACKEND", "jax")
    dev = AccurateRipCRC(False, False, 44100, n)
    dev.update_array(arr)
    assert dev.checksums() == host.checksums()


# ---------------------------------------------------------------------------
# ReplayGain


@pytest.mark.parametrize("rate", [44100, 48000, 8000])
def test_rg_device_matches_host(rate, monkeypatch):
    from audiotools_tpu.replaygain import ReplayGain

    arr = _signal(rate * 3, rate, seed=5)

    host_rg = ReplayGain(rate)
    (hg, hp) = host_rg.title_gain(_reader(arr, rate))

    monkeypatch.setenv("ATPU_RG_BACKEND", "jax")
    dev_rg = ReplayGain(rate)
    (dg, dp) = dev_rg.title_gain(_reader(arr, rate))

    # peaks are host-side in both paths: identical
    assert dp == hp
    # gains quantize to 0.01 dB histogram bins; the device FIR path
    # may flip a window on a bin boundary, moving the statistic by at
    # most one bin
    assert abs(dg - hg) <= 0.011, (dg, hg)
    # and the window histograms must be near-identical
    diff = np.abs(dev_rg.album_histogram - host_rg.album_histogram)
    assert diff.sum() <= 2 * 2  # at most 2 boundary windows moved


def test_rg_device_album_accumulation(monkeypatch):
    from audiotools_tpu.replaygain import ReplayGain

    a1 = _signal(44100 * 2, 44100, seed=6)
    a2 = _signal(44100 * 2, 44100, seed=7, amp=4000)

    host_rg = ReplayGain(44100)
    host_rg.title_gain(_reader(a1, 44100))
    host_rg.title_gain(_reader(a2, 44100))
    (hg, hp) = host_rg.album_gain()

    monkeypatch.setenv("ATPU_RG_BACKEND", "jax")
    dev_rg = ReplayGain(44100)
    dev_rg.title_gain(_reader(a1, 44100))
    dev_rg.title_gain(_reader(a2, 44100))
    (dg, dp) = dev_rg.album_gain()

    assert dp == hp
    assert abs(dg - hg) <= 0.011


def test_rg_fir_truncation_is_negligible():
    """the truncated combined impulse response carries all the
    filter's energy at every supported sample rate"""
    from audiotools_tpu.ops.replaygain_coeffs import SAMPLE_RATES
    for rate in SAMPLE_RATES:
        h = converters.rg_combined_fir(rate)
        assert len(h) >= 64
        tail = np.abs(h[-8:]).max()
        assert tail <= 1e-10 * np.abs(h).max()


# ---------------------------------------------------------------------------
# Resampler


@pytest.mark.parametrize("pair", [(96000, 44100), (44100, 48000),
                                  (22050, 44100)])
def test_resampler_device_matches_host(pair, monkeypatch):
    from audiotools_tpu.pcmconverter import Resampler

    (src, dst) = pair
    arr = _signal(src, src, seed=11)

    host_out = _drain(Resampler(_reader(arr, src), dst))
    monkeypatch.setenv("ATPU_RESAMPLE_BACKEND", "jax")
    dev_out = _drain(Resampler(_reader(arr, src), dst))

    assert host_out.shape == dev_out.shape
    # the device sums the taps in another order: integer outputs
    # match except on values within a few ulps of a rounding boundary
    diff = np.abs(host_out.astype(np.int64) - dev_out.astype(np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def _drain(reader):
    chunks = []
    frame = reader.read(4096)
    while frame.frames:
        chunks.append(np.array(frame.samples))
        frame = reader.read(4096)
    return np.concatenate(chunks) if chunks else np.zeros((0, 2))
