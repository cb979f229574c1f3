"""Device-sharded transcode farm over the virtual mesh.

ATPU_FARM_DEVICE_SHARD=1 pins each farm worker's analysis dispatches
to one mesh device (round-robin) — per-device batch queues, the
device replacement for the reference's fork-per-track
ExecProgressQueue (reference __init__.py:5263) when several chips are
attached.  On this box the mesh is 8 VIRTUAL CPU devices sharing one
core, so the assertions are about correctness and dispatch structure;
the wall-clock scaling curve is printed for the record, not
asserted.
"""

import io
import os
import time

import numpy as np
import pytest

from audiotools_tpu import pcm
from audiotools_tpu.pcmstream import PCMReader

SR = 44100


def _track(seed, seconds=1):
    rng = np.random.default_rng(seed)
    n = SR * seconds
    t = np.arange(n)
    arr = np.clip(
        8000 * np.sin(2 * np.pi * (300 + 40 * seed) * t / SR)[:, None]
        + rng.integers(-500, 500, (n, 2)), -32768, 32767
    ).astype(np.int32)
    return arr


def _wav_path(tmp_path, seed):
    from audiotools_tpu.formats.wav import WaveAudio
    arr = _track(seed)
    path = str(tmp_path / ("t%d.wav" % seed))
    fl = pcm.FrameList._wrap(arr, 16)
    WaveAudio.from_pcm(path, PCMReader(
        io.BytesIO(fl.to_bytes(False, True)), SR, 2, 3, 16))
    return (path, arr)


@pytest.mark.slow
def test_farm_device_shard_bit_exact(tmp_path, monkeypatch):
    """an 8-worker farm with per-device pinning produces files
    byte-identical to the unsharded single-worker farm"""
    from audiotools_tpu.formats.flac import FlacAudio
    from audiotools_tpu.parallel import farm

    monkeypatch.setenv("ATPU_FLAC_BACKEND", "jax")
    tracks = [_wav_path(tmp_path, s) for s in range(8)]

    def encode_all(tag, workers, shard):
        monkeypatch.setenv("ATPU_FARM_DEVICE_SHARD",
                           "1" if shard else "0")
        jobs = [farm.FarmJob(path, str(tmp_path / ("%s%d.flac"
                                                   % (tag, s))),
                             FlacAudio, compression="8")
                for (s, (path, _arr)) in enumerate(tracks)]
        t0 = time.perf_counter()
        results = farm.transcode(jobs, workers=workers)
        dt = time.perf_counter() - t0
        for r in results:
            assert r.ok, r.error
        return ([open(j.dest_path, "rb").read() for j in jobs], dt)

    (base, dt1) = encode_all("a", workers=1, shard=False)
    (sharded, dt8) = encode_all("b", workers=8, shard=True)
    assert base == sharded
    # for the record (a virtual mesh shares the host's cores: expect
    # ~flat)
    print("farm 1-worker unsharded: %.2fs; 8-worker device-sharded: "
          "%.2fs" % (dt1, dt8))


def test_thread_device_pin_roundtrip():
    """set_thread_device pins and clears per-thread"""
    import jax
    from audiotools_tpu.codecs import flac_enc_fast as fef

    dev = jax.devices()[-1]
    fef.set_thread_device(dev)
    assert fef._jax_device() is dev
    fef.set_thread_device(None)
    assert fef._jax_device() is None or fef._jax_device() is not dev
