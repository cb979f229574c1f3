"""Rules that keep the device paths honest: no hidden fallback to
other devices, one process per card, the compile cache's home, and a
chip smoke test that refuses to run without a GPU."""

import multiprocessing
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_mesh_raises_instead_of_falling_back():
    import jax
    from audiotools_tpu.parallel import mesh as mesh_mod

    have = len(jax.devices())
    with pytest.raises(ValueError, match="requested"):
        mesh_mod.make_mesh(have + 1)
    mesh = mesh_mod.make_mesh(min(have, 4))
    assert mesh.devices.size == min(have, 4)
    assert all(d.platform == jax.default_backend()
               for d in mesh.devices.flat)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX's own setting stands"""
    import jax
    from audiotools_tpu.codecs import flac_enc_fast as fef

    before = jax.config.jax_compilation_cache_dir
    chosen = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", chosen)
    monkeypatch.setattr(fef, "_cache_enabled", False)
    try:
        # what JAX reads from the variable when it is imported
        jax.config.update("jax_compilation_cache_dir", chosen)
        fef._enable_compilation_cache(jax)
        assert jax.config.jax_compilation_cache_dir == chosen
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_into_the_checkout(monkeypatch):
    import jax
    from audiotools_tpu.codecs import flac_enc_fast as fef

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(fef, "_cache_enabled", False)
    try:
        fef._enable_compilation_cache(jax)
        assert jax.config.jax_compilation_cache_dir == \
            os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("env,expect", [
    ({"ATPU_FLAC_DEC_BACKEND": "jax"}, True),
    ({"ATPU_RG_BACKEND": "jax"}, True),
    ({"JAX_PLATFORMS": "cuda"}, True),
    ({"JAX_PLATFORMS": None}, True),       # unset: JAX may pick a card
    ({"JAX_PLATFORMS": "cpu"}, False),
    ({"JAX_PLATFORMS": "cuda", "ATPU_FLAC_BACKEND": "numpy"}, False),
])
def test_device_jobs_rule(monkeypatch, env, expect):
    from audiotools_tpu.parallel.queue import device_jobs

    for key in list(os.environ):
        if key.startswith("ATPU_") and key.endswith("BACKEND"):
            monkeypatch.delenv(key)
    for (key, value) in env.items():
        if value is None:
            monkeypatch.delenv(key, raising=False)
        else:
            monkeypatch.setenv(key, value)
    assert device_jobs() is expect


def _no_fork(*args, **kwargs):
    raise AssertionError("a device job forked")


def _pid(progress=None):
    return os.getpid()


def test_device_jobs_run_in_this_process(monkeypatch):
    from audiotools_tpu.parallel.queue import ExecProgressQueue

    monkeypatch.setenv("ATPU_TTA_DEC_BACKEND", "jax")
    monkeypatch.setattr(multiprocessing, "Process", _no_fork)
    queue = ExecProgressQueue(None)
    for _ in range(4):
        queue.execute(_pid)
    assert queue.run(4) == [os.getpid()] * 4


def test_cli_device_jobs_never_fork(monkeypatch, tmp_path):
    """track2track -j 4 with a device decode backend selected keeps
    every job in the calling process"""
    from audiotools_tpu import pcm
    from audiotools_tpu.cli import track2track
    from audiotools_tpu.formats.wav import WaveAudio
    from audiotools_tpu.pcmstream import PCMReader
    import io

    sources = []
    for i in range(3):
        arr = np.random.default_rng(i).integers(
            -3000, 3000, (4410, 2)).astype(np.int32)
        data = pcm.FrameList._wrap(arr, 16).to_bytes(False, True)
        path = str(tmp_path / ("in%d.wav" % i))
        WaveAudio.from_pcm(path, PCMReader(io.BytesIO(data), 44100, 2,
                                           3, 16))
        sources.append(path)
    monkeypatch.setenv("ATPU_WV_DEC_BACKEND", "jax")
    monkeypatch.setattr(multiprocessing, "Process", _no_fork)
    out = tmp_path / "out"
    assert track2track.main(["-t", "flac", "-q", "8", "-j", "4",
                             "--format", "%(basename)s.%(suffix)s",
                             "-d", str(out)] + sources) == 0
    assert len(list(out.iterdir())) == 3


def test_chip_smoke_refuses_the_cpu():
    """no GPU: chip_smoke.py exits non-zero before any phase and
    prints no result"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    result = subprocess.run([sys.executable,
                             os.path.join(REPO, "chip_smoke.py")],
                            capture_output=True, text=True, env=env,
                            cwd=REPO, timeout=300)
    assert result.returncode != 0
    assert "phase" not in result.stdout
    assert '"ok"' not in result.stdout
    assert "not a GPU" in result.stderr
