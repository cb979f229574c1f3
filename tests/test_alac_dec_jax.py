"""Device ALAC decode (codecs/alac_dec_jax.py + ops/alac_synth.py).

The device path (host entropy scan + fused sign-adaptive predictor
scan) must decode byte-identically to the host decoder and the
oracle across the signal matrix.  Runs on the CPU JAX backend
(conftest); the same jitted programs serve the GPU.
"""

import io
import os

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader


def _reader(arr, bps=16, rate=44100):
    fl = pcm.FrameList._wrap(arr.astype(np.int32), bps)
    ch = arr.shape[1]
    mask = {1: 0x4, 2: 0x3, 4: 0x107, 6: 0x3F}.get(ch,
                                                   (1 << ch) - 1)
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                     rate, ch, mask, bps)


def _m4a(tmp_path, arr, bps=16, name="t.m4a"):
    from audiotools_tpu.formats.m4a import ALACAudio
    path = str(tmp_path / name)
    ALACAudio.from_pcm(path, _reader(arr, bps))
    return path


def _signals(bps=16):
    rng = np.random.default_rng(31)
    n = 44100
    t = np.arange(n)
    amp = 9000 if bps == 16 else 2300000
    tone = np.clip(amp * np.sin(2 * np.pi * 441 * t / 44100),
                   -(1 << (bps - 1)), (1 << (bps - 1)) - 1)
    tone = tone.astype(np.int32)
    noise = rng.integers(-amp // 4, amp // 4, n).astype(np.int32)
    mixed = np.concatenate(
        [np.zeros(9000, dtype=np.int32), tone[:20000],
         noise[:n - 29000]])
    return {
        "tone": np.stack([tone, (tone * 2) // 3], axis=1),
        "noise": np.stack([noise, -noise], axis=1),
        "mixed": np.stack([mixed, mixed[::-1]], axis=1),
        "mono": tone[:30011][:, None],
    }


def _drain(reader):
    chunks = []
    frame = reader.read(4096)
    while frame.frames:
        chunks.append(np.array(frame.samples))
        frame = reader.read(4096)
    reader.close()
    return (np.concatenate(chunks) if chunks
            else np.zeros((0, 1), dtype=np.int32))


@pytest.mark.parametrize("name", ["tone", "noise", "mixed", "mono"])
def test_device_decode_byte_identical_16(name, tmp_path, monkeypatch):
    from audiotools_tpu.codecs.alac import decoder_for_file

    arr = _signals()[name]
    path = _m4a(tmp_path, arr)
    host = _drain(decoder_for_file(path))
    monkeypatch.setenv("ATPU_ALAC_DEC_BACKEND", "jax")
    dev = _drain(decoder_for_file(path))
    assert np.array_equal(host, dev)
    assert np.array_equal(dev, arr)


def test_device_decode_24bit(tmp_path, monkeypatch):
    from audiotools_tpu.codecs.alac import decoder_for_file

    arr = _signals(24)["tone"]
    path = _m4a(tmp_path, arr, bps=24)
    host = _drain(decoder_for_file(path))
    monkeypatch.setenv("ATPU_ALAC_DEC_BACKEND", "jax")
    dev = _drain(decoder_for_file(path))
    assert np.array_equal(host, dev)
    assert np.array_equal(dev, arr)


def test_device_decode_multichannel(tmp_path, monkeypatch):
    from audiotools_tpu.codecs.alac import decoder_for_file

    rng = np.random.default_rng(5)
    arr = rng.integers(-8000, 8000, (22050, 4)).astype(np.int32)
    path = _m4a(tmp_path, arr)
    host = _drain(decoder_for_file(path))
    monkeypatch.setenv("ATPU_ALAC_DEC_BACKEND", "jax")
    dev = _drain(decoder_for_file(path))
    assert np.array_equal(host, dev)
    assert np.array_equal(dev, arr)


def test_synth_op_matches_oracle_subframe():
    """the fused predictor scan vs the oracle's scalar
    decode_subframe, over adversarial residual patterns"""
    import jax.numpy as jnp
    from audiotools_tpu.ops import alac_synth
    from audiotools_tpu.ref.alac import ALACDecoder

    rng = np.random.default_rng(17)
    n = 256
    S = 6
    orders = [1, 2, 4, 8, 4, 8]
    shift = np.array([9, 9, 7, 9, 12, 9], dtype=np.int32)
    sample_size = np.full(S, 17, dtype=np.int32)
    residuals = rng.integers(-1500, 1500, (S, n)).astype(np.int32)
    residuals[2, :16] = 0                       # zero-run stress
    residuals[3] = np.abs(residuals[3])         # positive-heavy
    qlp0 = np.zeros((S, alac_synth.K), dtype=np.int32)
    for (s, o) in enumerate(orders):
        qlp0[s, :o] = rng.integers(-2000, 2000, o)

    expected = np.zeros((S, n), dtype=np.int32)
    for s in range(S):
        coeffs = [int(v) for v in qlp0[s, :orders[s]]]
        out = ALACDecoder.decode_subframe(
            None, int(shift[s]), coeffs, int(sample_size[s]),
            [int(v) for v in residuals[s]])
        expected[s] = out

    order_arr = np.asarray(orders, dtype=np.int32)
    got_np = alac_synth.synthesize(
        np, residuals, qlp0, order_arr, shift, sample_size, n)
    assert np.array_equal(got_np, expected)
    got_jax = np.asarray(alac_synth.synthesize(
        jnp, residuals, qlp0, order_arr, shift, sample_size, n))
    assert np.array_equal(got_jax, expected)


def test_synth_op_diff_chain_order31():
    import jax.numpy as jnp
    from audiotools_tpu.ops import alac_synth
    from audiotools_tpu.ref.alac import ALACDecoder

    rng = np.random.default_rng(3)
    n = 128
    residuals = rng.integers(-900, 900, (1, n)).astype(np.int32)
    expected = ALACDecoder.decode_subframe(
        None, 9, [0] * 31, 17, [int(v) for v in residuals[0]])
    got = alac_synth.synthesize(
        np, residuals, np.zeros((1, alac_synth.K), np.int32),
        np.array([31], np.int32), np.array([9], np.int32),
        np.array([17], np.int32), n)
    assert np.array_equal(got[0], expected)
    got_j = np.asarray(alac_synth.synthesize(
        jnp, residuals, np.zeros((1, alac_synth.K), np.int32),
        np.array([31], np.int32), np.array([9], np.int32),
        np.array([17], np.int32), n))
    assert np.array_equal(got_j[0], expected)
