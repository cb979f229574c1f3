"""Decoder strictness: malformed streams must raise, never pass.

The encoder's compliance evidence leans on self-decode (no external
``flac`` binary exists in this environment),
so the decoder itself must demonstrably REJECT malformed input for the
round trip to mean anything: a decoder that shrugs at bad CRCs or
trailing garbage would also shrug at encoder bugs.

Reference counterparts: ``src/decoders/flac.c`` CRC8/CRC16/MD5 checks
(flac.c:214-222, 247-254, 195-207) and the bad-file fixtures of
``test/test_formats.py``.
"""

import io

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader
from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
from audiotools_tpu.codecs.flac_dec_fast import FastFlacDecoder


def _signal(n, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = (8000 * np.sin(2 * np.pi * 441 * t / 44100)[:, None] +
           rng.normal(0, 500, (n, 2)))
    return np.clip(sig, -32768, 32767).astype(np.int32)


@pytest.fixture(scope="module")
def good_flac():
    arr = _signal(44100 * 2)
    raw = pcm.FrameList._wrap(arr, 16).to_bytes(False, True)
    buf = io.BytesIO()
    encode_flac_fast(buf, PCMReader(io.BytesIO(raw), 44100, 2, 3, 16),
                     max_lpc_order=8, backend="numpy")
    return (buf.getvalue(), arr)


def _frames_offset(data):
    """byte offset of the first FLAC frame (skips metadata blocks)"""
    assert data[:4] == b"fLaC"
    off = 4
    last = 0
    while not last:
        header = int.from_bytes(data[off:off + 4], "big")
        last = header >> 31
        length = header & 0xFFFFFF
        off += 4 + length
    return off


def _drain(dec):
    out = []
    while True:
        fl = dec.read(65536)
        if fl.frames == 0:
            return out
        out.append(fl.samples)


def test_good_stream_decodes(good_flac):
    (data, arr) = good_flac
    got = np.concatenate(_drain(FastFlacDecoder(io.BytesIO(data))))
    assert np.array_equal(got, arr)


def test_flipped_frame_body_bit_raises(good_flac):
    """a bit flip inside frame data must trip CRC16 (or MD5)"""
    (data, _arr) = good_flac
    off = _frames_offset(data)
    bad = bytearray(data)
    bad[off + 40] ^= 0x10              # inside the first frame body
    with pytest.raises(ValueError):
        _drain(FastFlacDecoder(io.BytesIO(bytes(bad))))


def test_flipped_frame_header_bit_raises(good_flac):
    """a frame-header bit flip must trip CRC8 (or fail to parse)"""
    (data, _arr) = good_flac
    off = _frames_offset(data)
    bad = bytearray(data)
    bad[off + 2] ^= 0x04               # header byte (after sync code)
    with pytest.raises(ValueError):
        _drain(FastFlacDecoder(io.BytesIO(bytes(bad))))


def test_truncated_stream_raises(good_flac):
    """a stream cut mid-frame must not decode cleanly to EOF"""
    (data, _arr) = good_flac
    off = _frames_offset(data)
    cut = data[:off + (len(data) - off) // 2 + 17]
    with pytest.raises(ValueError):
        _drain(FastFlacDecoder(io.BytesIO(cut)))


def test_trailing_garbage_raises_even_with_zero_md5(good_flac):
    """undecodable trailing bytes must raise even when STREAMINFO's
    MD5 is zeroed (unset), where the MD5 check can't catch it"""
    (data, _arr) = good_flac
    bad = bytearray(data)
    # zero the STREAMINFO MD5 (last 16 bytes of the 34-byte block
    # that follows the 4-byte block header after 'fLaC')
    md5_at = 4 + 4 + 34 - 16
    bad[md5_at:md5_at + 16] = b"\x00" * 16
    # claim more total frames than the stream holds so the decoder
    # can't use the frame count to stop cleanly before the garbage
    bad += b"\xDE\xAD\xBE\xEF" * 16
    total_at = 4 + 4 + 13          # 36-bit total spans bytes 13..17
    bad[total_at + 4] = 0xFF       # bump the low byte of total frames
    with pytest.raises(ValueError):
        _drain(FastFlacDecoder(io.BytesIO(bytes(bad))))


def test_md5_mismatch_raises(good_flac):
    """a wrong STREAMINFO MD5 must be reported at end of stream"""
    (data, _arr) = good_flac
    bad = bytearray(data)
    md5_at = 4 + 4 + 34 - 16
    bad[md5_at] ^= 0xFF
    with pytest.raises(ValueError, match="MD5"):
        _drain(FastFlacDecoder(io.BytesIO(bytes(bad))))


def test_not_a_flac_file():
    with pytest.raises(ValueError):
        FastFlacDecoder(io.BytesIO(b"RIFF" + b"\x00" * 64))
