"""Compression-ratio regression gate vs the reference fixture corpus.

Pins the measured ratio win (BASELINE.md round-3/4: corpus-wide
-11.2%, every fixture <= reference) so encoder retunes — the noise
detector, quantization defaults, Rice-search changes — cannot
silently trade compression away.  Protocol is exactly
``tools_dev/ratio_parity.py``: decode every reference ``test/*.flac``
fixture, re-encode at -8, compare audio-stream bytes (metadata
excluded on both sides).  Reference corpus files:
``/root/reference/test/tone*.flac`` (libFLAC 1.2.1 sweeps) and the
Python Audio Tools-made silence/metadata fixtures.

Slow battery (multi-minute: the full corpus re-encodes on the numpy
backend); the default run keeps a single-fixture representative.
"""

import io
import os

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
from audiotools_tpu.pcmstream import PCMReader

REF_TEST = "/root/reference/test"

requires_corpus = pytest.mark.skipif(
    not os.path.isdir(REF_TEST),
    reason="reference fixture corpus not present")


def audio_stream_bytes_of(data):
    """frame-data byte count past fLaC + metadata blocks"""
    pos = data.index(b"fLaC") + 4
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        length = int.from_bytes(hdr[1:4], "big")
        pos += 4 + length
        if last:
            break
    return len(data) - pos


def reencode_stream_bytes(path):
    """(reference_bytes, our_bytes) for one fixture, -8 re-encode"""
    from audiotools_tpu.formats.flac import FlacAudio
    f = FlacAudio(path)
    reader = f.to_pcm()
    out = []
    fl = reader.read(1 << 18)
    while fl.frames:
        out.append(fl.samples)
        fl = reader.read(1 << 18)
    reader.close()
    arr = np.concatenate(out)
    fl2 = pcm.FrameList._wrap(np.ascontiguousarray(arr),
                              f.bits_per_sample())
    rd = PCMReader(
        io.BytesIO(fl2.to_bytes(False, f.bits_per_sample() > 8)),
        f.sample_rate(), f.channels(), int(f.channel_mask()),
        f.bits_per_sample())
    buf = io.BytesIO()
    encode_flac_fast(buf, rd, backend="numpy", padding_size=None,
                     block_size=4096, max_lpc_order=12,
                     mid_side=f.channels() == 2,
                     exhaustive_model_search=True,
                     max_residual_partition_order=6)
    with open(path, "rb") as fh:
        ref_data = fh.read()
    return (audio_stream_bytes_of(ref_data),
            audio_stream_bytes_of(buf.getvalue()))


def corpus_fixtures():
    if not os.path.isdir(REF_TEST):
        return []
    return sorted(
        name for name in os.listdir(REF_TEST)
        if name.endswith(".flac") and name != "1h.flac")


@requires_corpus
def test_single_fixture_not_larger():
    """fast representative: the libFLAC-1.2.1 sweep tone1.flac must
    re-encode strictly smaller (measured -14.5%; gate at parity)"""
    (ref, ours) = reencode_stream_bytes(
        os.path.join(REF_TEST, "tone1.flac"))
    assert ours <= ref, (
        "tone1.flac re-encode grew: ref %d, ours %d" % (ref, ours))


@pytest.mark.slow
@requires_corpus
def test_corpus_ratio_holds():
    """the full ratio_parity protocol: corpus delta <= -9% AND every
    fixture <= reference (the ratio regression gate)"""
    total_ref = total_ours = 0
    larger = []
    for name in corpus_fixtures():
        try:
            (ref, ours) = reencode_stream_bytes(
                os.path.join(REF_TEST, name))
        except Exception:  # noqa: B902  (unreadable fixture: skip,
            continue       # matching ratio_parity.py's SKIP rows)
        total_ref += ref
        total_ours += ours
        if ours > ref:
            larger.append((name, ref, ours))
    assert total_ref > 0, "no corpus fixtures decoded"
    delta_pct = 100.0 * (total_ours - total_ref) / total_ref
    assert not larger, (
        "fixtures grew vs reference: %r" % (larger,))
    assert delta_pct <= -9.0, (
        "corpus ratio regressed: delta %.2f%% (gate: <= -9%%)"
        % (delta_pct,))
