"""Equivalence tests for the device-side parallel bitpack.

The parallel program (ops/pallas_bitpack.py — prefix-summed token
offsets + scatter-add) must produce bit-for-bit the stream the serial
writers produce.  The serial reference here is
``ref/flac_enc.write_residual_block`` (TokenStream), which the oracle
suites hold byte-identical to the C++ emitter — so equality below is
transitively equality with ``_native.atpu_flac_emit_frames2``'s
residual sections.  Runs the numpy scatter and the XLA scatter.
"""

import numpy as np
import pytest

from audiotools_tpu.ops import pallas_bitpack as pb
from audiotools_tpu.ref.flac_enc import TokenStream, write_residual_block


def serial_block(n, order, porder, params, res):
    """the serial reference bytes for one residual partition block"""
    t = TokenStream()
    write_residual_block(t, n, order, porder, list(params), res)
    return t.to_bytes()


def make_case(rng, n, max_parts, scale):
    porder = int(rng.integers(0, max_parts.bit_length()))
    while n % (1 << porder):
        porder = int(rng.integers(0, max_parts.bit_length()))
    parts = 1 << porder
    order = int(rng.integers(0, min(13, (n >> porder))))
    res = rng.integers(-scale, scale, n).astype(np.int64)
    res[:order] = 0
    params = np.zeros(max_parts, dtype=np.int32)
    psize = n >> porder
    for p in range(parts):
        seg = np.abs(res[p * psize:(p + 1) * psize]).sum()
        cnt = max(psize - (order if p == 0 else 0), 1)
        r = 0
        while (cnt << r) < seg and r < 30:
            r += 1
        params[p] = r
    return (order, porder, params, res)


def batch_cases(seed=1, n=256, S=6, max_parts=8, scales=(4, 100, 5000)):
    rng = np.random.default_rng(seed)
    orders = np.zeros(S, dtype=np.int32)
    porders = np.zeros(S, dtype=np.int32)
    params = np.zeros((S, max_parts), dtype=np.int32)
    res = np.zeros((S, n), dtype=np.int64)
    for s in range(S):
        (o, p, pp, r) = make_case(rng, n, max_parts,
                                  scales[s % len(scales)])
        orders[s] = o
        porders[s] = p
        params[s] = pp
        res[s] = r
    return (orders, porders, params, res)


def check_backend(backend, seed=1, n=256, S=6):
    (orders, porders, params, res) = batch_cases(seed=seed, n=n, S=S)
    n_words = pb.words_needed(n, 16, params.shape[1])
    (words, bits) = pb.pack_residual_blocks(
        res, orders, porders, params, n_words, backend=backend)
    words = np.asarray(words)
    bits = np.asarray(bits)
    for s in range(S):
        expect = serial_block(n, int(orders[s]), int(porders[s]),
                              params[s], res[s])
        got = pb.words_to_bytes(words[s], bits[s])
        assert got == expect, \
            "backend=%s subframe %d differs" % (backend, s)


def test_numpy_scatter_matches_serial():
    check_backend("numpy")


def test_xla_scatter_matches_serial():
    check_backend("xla")


def test_numpy_large_blocks_and_zero_order():
    check_backend("numpy", seed=7, n=4096, S=4)


def test_xla_scatter_large_blocks():
    check_backend("xla", seed=7, n=4096, S=4)


def test_method1_large_parameters():
    """24-bit-scale residuals force coding method 1 (5-bit params)"""
    rng = np.random.default_rng(3)
    n = 256
    res = rng.integers(-(1 << 22), 1 << 22, n).astype(np.int64)
    params = np.full((1, 4), 20, dtype=np.int32)
    n_words = pb.words_needed(n, 26, 4)
    (words, bits) = pb.pack_residual_blocks(
        res[None], np.array([0], np.int32), np.array([2], np.int32),
        params, n_words, backend="numpy")
    expect = serial_block(n, 0, 2, params[0], res)
    assert pb.words_to_bytes(words[0], bits[0]) == expect


# ---------------------------------------------------------------------
# production path: ATPU_PALLAS=1 routes encode_flac_fast's jax backend
# through device residual packing + the emit splice
# (_native.flac_emit_frames2 rb_words/rb_bits)
# ---------------------------------------------------------------------

def _encode_bytes(arr, bps, backend, monkeypatch, pallas):
    import io
    from audiotools_tpu import pcm
    from audiotools_tpu.pcmstream import PCMReader
    from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast

    monkeypatch.setenv("ATPU_PALLAS", "1" if pallas else "0")
    # device packing requires exact uploads, so it implies qpack off;
    # the host baseline must analyze the same (exact) samples or its
    # decisions legitimately differ by a few bits per frame
    monkeypatch.setenv("ATPU_FLAC_QPACK", "0")
    # the splice path serializes the DEVICE-chosen (porder, params)
    # verbatim, so the host baseline must not re-search them at emit
    # (the analysis search is already exact on exact uploads; only
    # tie-breaking could differ between the two searches)
    monkeypatch.setenv("ATPU_EMIT_EXACT_RICE", "0")
    fl = pcm.FrameList._wrap(arr, bps)
    mask = {1: 4, 2: 3}[arr.shape[1]]
    reader = PCMReader(io.BytesIO(fl.to_bytes(False, bps > 8)),
                       44100, arr.shape[1], mask, bps)
    buf = io.BytesIO()
    encode_flac_fast(buf, reader, backend=backend, block_size=4096,
                     max_lpc_order=8, mid_side=arr.shape[1] == 2,
                     exhaustive_model_search=False,
                     max_residual_partition_order=4, batch_frames=8)
    return buf.getvalue()


# one XLA compile per (channels, bps) signature; default run keeps
# the stereo 16-bit representative
@pytest.mark.parametrize("bps,ch", [
    (16, 2),
    pytest.param(16, 1, marks=pytest.mark.slow),
    pytest.param(24, 2, marks=pytest.mark.slow)])
def test_pallas_encode_path_byte_identity(monkeypatch, bps, ch):
    """a complete .flac emitted through the device-packed residual
    splice is byte-identical to the host serializer's file"""
    rng = np.random.default_rng(9)
    n = 4096 * 9 + 1000          # incl. a padded partial batch + tail
    t = np.arange(n)
    amp = 1 << (bps - 3)
    arr = np.stack([(amp * np.sin(2 * np.pi * (300 + 200 * c) * t
                                  / 44100)).astype(np.int64)
                    + rng.integers(-amp // 64, amp // 64, n)
                    for c in range(ch)], axis=1).astype(np.int32)
    # constant + verbatim stretches exercise the non-spliced choices
    arr[:4096] = 1234 if bps > 8 else 12
    host = _encode_bytes(arr, bps, "numpy", monkeypatch, pallas=False)
    dev = _encode_bytes(arr, bps, "jax", monkeypatch, pallas=True)
    assert host == dev
