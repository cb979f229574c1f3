"""A codec matrix run on the JAX backend proper.

Most of the suite exercises the numpy analysis backend (byte-identical
by the contraction-immune kernel spec); this module drives the fast
encoders' REAL jax path — jit, batch-shape padding grid, qpack wire
format, device fetch pipeline — across a small signal matrix and
requires byte equality with the numpy backend plus losslessness.
Keeps the production code path in the default unit run; conftest pins
JAX to the CPU, so these compiles are local CPU XLA.

Reference counterpart: test/test_formats.py's C-vs-Python encoder
equivalence sweeps (test_formats.py:4075-4130).
"""

import io
import os

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader

SR = 44100


def make_reader(kind, bps, channels, n):
    # crc32, not hash(): string hashing is randomized per process
    # (PYTHONHASHSEED), which would make failures non-reproducible
    import zlib
    seed = zlib.crc32(f"{kind}/{bps}/{channels}".encode())
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    amp = 1 << (bps - 3)
    if kind == "tone":
        base = amp * np.sin(2 * np.pi * 441 * t / SR)
    elif kind == "noise":
        base = rng.integers(-amp, amp, n).astype(np.float64)
    else:  # transient: silence -> burst -> decay
        base = np.where((t // 2048) % 3 == 1,
                        amp * np.sin(2 * np.pi * 997 * t / SR), 0.0)
    chs = [np.roll(base, 37 * i) for i in range(channels)]
    arr = np.stack(chs, 1).astype(np.int64).astype(np.int32)
    fl = pcm.FrameList._wrap(arr, bps)
    mask = {1: 0x4, 2: 0x3}[channels]
    return (arr, PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                           SR, channels, mask, bps))


def flac_decode_all(data, bps, channels, n):
    from audiotools_tpu import _native
    from audiotools_tpu.bitstream import BitstreamReader
    r = BitstreamReader(data, False)
    r.skip_bytes(4)
    last = 0
    while last != 1:
        (last, _btype, blen) = r.parse("1u 7u 24u")
        r.skip_bytes(blen)
    offset = r.source.tell()
    (samples, _consumed) = _native.flac_decode(
        data[offset:], bps, channels, n)
    return samples


@pytest.fixture(autouse=True)
def small_batches(monkeypatch):
    # small static batches keep the per-combination jit compile cheap
    # while still exercising the grid (3 full blocks pad to 4)
    monkeypatch.setenv("ATPU_FLAC_BATCH", "16")
    monkeypatch.setenv("ATPU_ALAC_BATCH", "16")


@pytest.mark.parametrize("kind", ["tone", "noise", "transient"])
@pytest.mark.parametrize("bps,channels", [(16, 2), (24, 2), (16, 1)])
def test_flac_jax_matrix(kind, bps, channels):
    from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast

    n = 4096 * 3 + 1000
    (arr, _) = make_reader(kind, bps, channels, n)
    outs = {}
    for backend in ("jax", "numpy"):
        (_, reader) = make_reader(kind, bps, channels, n)
        buf = io.BytesIO()
        encode_flac_fast(buf, reader, backend=backend)
        outs[backend] = buf.getvalue()
    assert outs["jax"] == outs["numpy"]
    decoded = flac_decode_all(outs["jax"], bps, channels, n)
    assert np.array_equal(decoded, arr)


@pytest.mark.parametrize("kind", ["tone", "noise"])
@pytest.mark.parametrize("bps", [16, 24])
def test_alac_jax_matrix(kind, bps):
    from audiotools_tpu.codecs.alac_fast import encode_mdat_fast

    n = 4096 * 3 + 700
    (arr, _) = make_reader(kind, bps, 2, n)
    outs = {}
    for backend in ("jax", "numpy"):
        (_, reader) = make_reader(kind, bps, 2, n)
        buf = io.BytesIO()
        encode_mdat_fast(buf, reader, backend=backend)
        outs[backend] = buf.getvalue()
    assert outs["jax"] == outs["numpy"]
