#!/usr/bin/env python
"""Smoke test: the system's main paths on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-3 on one card
    python chip_smoke.py --gpus 4   # the four-card paths (phase 4) only

0. device: JAX's first device must be a GPU; otherwise the script exits
   non-zero before any phase runs.
1. FLAC -8 encode at production width (1024-block batches of 4096
   frames, 44.1 kHz 16-bit stereo): several full batches plus a partial
   one and a short tail through ``encode_flac_fast(backend="jax")``,
   byte-identical to the numpy backend on a stream one batch long, the
   native decode equal to the input and the STREAMINFO MD5 checked; the
   ``track2track -> trackverify -> trackcmp`` loop called in this
   process; one batch of 24-bit 6-channel audio and one ALAC encode,
   each byte-identical to the numpy backend.
2. device decode (``ATPU_*_DEC_BACKEND=jax``) of FLAC, ALAC, TTA,
   WavPack and Shorten, sample for sample against the host decoders;
   the first FLAC batch must take the int32 synthesis.
3. device converters: resampling 96k -> 44.1k within 1 LSB of the host
   kernel, ReplayGain within 0.01 dB, AccurateRip exact.
4. (``--gpus 4`` only) a sharded encode over four cards byte-identical
   to the numpy backend, and a device-sharded farm identical to a
   one-card farm.

Every comparison raises on failure; nothing is caught.  Timings are
printed for information only, beside the card's name and power limit.
The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Everything runs in this one process, which holds the card(s).
"""

import argparse
import glob
import hashlib
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SR = 44100
BLOCK = 4096

# production sizes; a rehearsal on the CPU imports this module and
# passes smaller ones to the phase functions
FULL = dict(batch=1024, enc_batches=4, seconds=30, farm_tracks=8,
            farm_seconds=20)


def log(*args):
    print(*args, flush=True)


def card_line():
    """the card's name and power limit as nvidia-smi reports them"""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def pcm_bytes(arr, bps):
    from audiotools_tpu import pcm
    return pcm.FrameList._wrap(arr, bps).to_bytes(False, True)


def reader_for(arr, bps=16, rate=SR):
    from bench_all import reader_for as make_reader
    return make_reader(arr, bps, rate)


def drain(reader):
    from bench_all import drain as drain_reader
    try:
        return drain_reader(reader)
    finally:
        reader.close()


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log("  ok:", what)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return (out, time.perf_counter() - t0)


def flac_payload_offset(data):
    """byte offset of the first frame after the metadata blocks"""
    pos = 4
    last = 0
    while not last:
        last = data[pos] >> 7
        pos += 4 + int.from_bytes(data[pos + 1:pos + 4], "big")
    return pos


def encode(arr, backend, bps=16, **opts):
    from audiotools_tpu.pcmstream import PCMReader
    from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
    masks = {2: 0x3, 6: 0x3F}
    reader = PCMReader(io.BytesIO(pcm_bytes(arr, bps)), SR,
                       arr.shape[1], masks[arr.shape[1]], bps)
    buf = io.BytesIO()
    encode_flac_fast(buf, reader, backend=backend, **opts)
    return buf.getvalue()


# ---------------------------------------------------------------------
# phase 1: encode


def phase_encode(sz, card, tmp):
    import numpy as np
    import jax
    import bench
    import bench_all
    from audiotools_tpu import _native
    from audiotools_tpu.codecs import flac_enc_fast
    from audiotools_tpu.codecs.flac_dec_fast import FastFlacDecoder
    from audiotools_tpu.codecs.alac_fast import encode_mdat_fast

    log("phase 1: FLAC -8 encode")
    opts = dict(bench.OPTS, batch_frames=sz["batch"])
    batch_frames = BLOCK * sz["batch"]
    n_frames = (batch_frames * sz["enc_batches"] +
                BLOCK * (sz["batch"] // 2) + 1234)
    arr = bench.make_signal(n_frames)
    log("  stream: %d frames (%.1f s), %d full batches of %d blocks "
        "+ a partial batch + a %d-frame tail" %
        (n_frames, n_frames / SR, sz["enc_batches"], sz["batch"], 1234))

    # the analysis program's arguments, for its memory analysis
    calls = []
    analyze_q = flac_enc_fast._analyze_jax_q

    def spy(*args, **kwargs):
        calls.append(inspect.signature(analyze_q).bind(*args, **kwargs))
        return analyze_q(*args, **kwargs)

    flac_enc_fast._analyze_jax_q = spy
    try:
        # one full batch + tail: byte-identical to the numpy backend
        short = np.ascontiguousarray(arr[:batch_frames + 3000])
        (dev_short, t_cold) = timed(encode, short, "jax", **opts)
        host_short = encode(short, "numpy", **opts)
        check(dev_short == host_short,
              "jax encode of one batch + tail == numpy backend "
              "(%d bytes)" % len(host_short))
        log("  info: first jax encode (compiles) %.3f s" % t_cold)

        (data, dt) = timed(encode, arr, "jax", **opts)
    finally:
        flac_enc_fast._analyze_jax_q = analyze_q

    bound = calls[0].arguments
    wire = bound["wire"]
    fn = [f for (k, f) in flac_enc_fast._jax_analyze_cache.items()
          if k[0] == "q" and k[1] == wire.shape][0]
    mem = fn.lower(wire, bound["window"]).compile().memory_analysis()
    log("  analysis program [%s wire %s]: %s" %
        (wire.dtype, wire.shape, mem))

    log("  info: %d frames in %.3f s = %.3f Msamples/s (%s)" %
        (n_frames, dt, arr.size / dt / 1e6, card))
    # (wire shape, k, E) of every quantized-wire program built so far:
    # each new one compiled inside the timed encodes
    programs = sorted((key[1], key[2], key[16])
                      for key in flac_enc_fast._jax_analyze_cache
                      if key[0] == "q")
    log("  info: %d analysis programs built in this process, "
        "(wire shape, k, E): %s" % (len(programs), programs))
    off = flac_payload_offset(data)
    (samples, _used) = _native.flac_decode(data[off:], 16, 2, n_frames)
    check(np.array_equal(samples, arr),
          "native decode == input (%d frames)" % n_frames)
    md5 = data[8 + 18:8 + 34]
    check(md5 == hashlib.md5(pcm_bytes(arr, 16)).digest(),
          "STREAMINFO MD5 == MD5 of the input PCM")
    got = drain(FastFlacDecoder(io.BytesIO(data)))
    check(np.array_equal(got, arr),
          "host decoder (MD5 verified at EOF) == input")

    # the CLI loop, in this process (the queue runs device jobs inline)
    from audiotools_tpu.cli import track2track, trackverify, trackcmp
    from audiotools_tpu.formats.wav import WaveAudio
    from audiotools_tpu.parallel.queue import device_jobs
    cli_arr = bench.make_signal(SR * sz["seconds"], seed=11)
    wav = os.path.join(tmp, "cli_in.wav")
    WaveAudio.from_pcm(wav, reader_for(cli_arr))
    outdir = os.path.join(tmp, "cli_out")
    log("  CLI jobs run in this process: %s" % device_jobs())
    check(track2track.main(["-t", "flac", "-q", "8", "-d", outdir,
                            wav]) == 0, "track2track -t flac -q 8")
    (out,) = glob.glob(os.path.join(outdir, "*.flac"))
    check(trackverify.main([out]) == 0, "trackverify")
    check(trackcmp.main([wav, out]) == 0, "trackcmp")

    # BASELINE config-3 edge case: one batch of 24-bit 6-channel audio
    six = bench_all.make_signal(batch_frames, 6, 24, seed=9)
    six_opts = dict(opts, mid_side=False)
    (dev6, t6) = timed(encode, six, "jax", bps=24, **six_opts)
    host6 = encode(six, "numpy", bps=24, **six_opts)
    check(dev6 == host6, "24-bit 6-channel batch: jax == numpy "
          "(%d bytes)" % len(host6))
    log("  info: 24-bit 6-channel jax encode %.3f s (compiles)" % t6)

    alac_arr = bench.make_signal(SR * sz["seconds"], seed=12)
    alac = {}
    for backend in ("jax", "numpy"):
        buf = io.BytesIO()
        encode_mdat_fast(buf, reader_for(alac_arr), backend=backend)
        alac[backend] = buf.getvalue()
    check(alac["jax"] == alac["numpy"],
          "ALAC encode_mdat_fast: jax == numpy (%d bytes)" %
          len(alac["numpy"]))
    jax.effects_barrier()
    return (arr, data)


# ---------------------------------------------------------------------
# phase 2: device decode


def phase_decode(sz, card, tmp, arr, data):
    import numpy as np
    import bench
    from audiotools_tpu.codecs import flac_dec_jax
    from audiotools_tpu.codecs.flac_dec_jax import JaxFlacDecoder
    from audiotools_tpu.formats.m4a import ALACAudio
    from audiotools_tpu.formats.tta import TrueAudio
    from audiotools_tpu.formats.wavpack import WavPackAudio
    from audiotools_tpu.formats.shn import ShortenAudio

    log("phase 2: device decode")
    keys = []
    get_jit = flac_dec_jax._get_decode_jit

    def spy(key):
        keys.append(key)
        return get_jit(key)

    flac_dec_jax._get_decode_jit = spy
    try:
        (got, dt) = timed(drain, JaxFlacDecoder(io.BytesIO(data)))
    finally:
        flac_dec_jax._get_decode_jit = get_jit
    check(np.array_equal(got, arr),
          "FLAC device decode == host decode (%d frames)" % len(arr))
    log("  info: first FLAC device decode (compiles) %.3f s" % dt)
    (n, _ch, S_pad, _F, _buckets, Kw, _narrow, use_i32, _aligned) = \
        keys[0]
    check(use_i32, "first batch [%d x %d] (Kw %d) takes the int32 "
          "synthesis" % (S_pad, n, Kw))
    (_, dt) = timed(drain, JaxFlacDecoder(io.BytesIO(data)))
    log("  info: warm FLAC device decode %.3f s (%s)" % (dt, card))

    src = bench.make_signal(SR * sz["seconds"], seed=21)
    for (cls, var) in ((ALACAudio, "ATPU_ALAC_DEC_BACKEND"),
                       (TrueAudio, "ATPU_TTA_DEC_BACKEND"),
                       (WavPackAudio, "ATPU_WV_DEC_BACKEND"),
                       (ShortenAudio, "ATPU_SHN_DEC_BACKEND")):
        path = os.path.join(tmp, "dec." + cls.SUFFIX)
        cls.from_pcm(path, reader_for(src))
        os.environ.pop(var, None)
        host = drain(cls(path).to_pcm())
        os.environ[var] = "jax"
        try:
            (dev, dt) = timed(drain, cls(path).to_pcm())
        finally:
            del os.environ[var]
        check(np.array_equal(host, src) and np.array_equal(dev, host),
              "%s device decode == host decode (%d frames)" %
              (cls.SUFFIX, len(src)))
        log("  info: %s device decode %.3f s incl. compile" %
            (cls.SUFFIX, dt))


# ---------------------------------------------------------------------
# phase 3: converters


def phase_converters(sz, card):
    import numpy as np
    import bench_all
    from audiotools_tpu.pcmconverter import Resampler
    from audiotools_tpu.replaygain import ReplayGain
    from audiotools_tpu.accuraterip_checksum import accuraterip_checksums

    log("phase 3: device converters")
    src = bench_all.make_signal(96000 * sz["seconds"], 2, 16,
                                rate=96000)
    envs = ("ATPU_RESAMPLE_BACKEND", "ATPU_RG_BACKEND", "ATPU_AR_BACKEND")

    def run_all(backend):
        for var in envs:
            os.environ[var] = backend
        try:
            out = drain(Resampler(reader_for(src, rate=96000), SR))
            (gain, peak) = ReplayGain(SR).title_gain(reader_for(out))
            crc = accuraterip_checksums(reader_for(out), out.shape[0],
                                        True, True)
        finally:
            for var in envs:
                del os.environ[var]
        return (out, gain, peak, crc)

    (host, g_host, p_host, crc_host) = run_all("")
    (dev, g_dev, p_dev, crc_dev) = run_all("jax")
    delta = np.abs(dev.astype(np.int64) - host.astype(np.int64))
    log("  resample 96k -> 44.1k: %d of %d samples differ from the host"
        " (f64 sums in another order)" % (int((delta != 0).sum()),
                                           delta.size))
    check(dev.shape == host.shape and int(delta.max()) <= 1,
          "resample within 1 LSB of the host kernel")
    check(abs(g_dev - g_host) <= 0.01 and p_dev == p_host,
          "ReplayGain title gain %.4f dB vs host %.4f dB (<= 0.01)" %
          (g_dev, g_host))
    check(crc_dev == crc_host, "AccurateRip V1/V2 == host (%08X %08X)"
          % crc_host)


# ---------------------------------------------------------------------
# phase 4: four cards


def phase_four(sz, card, tmp, n_dev):
    import jax
    import bench
    from audiotools_tpu.codecs import flac_enc_fast
    from audiotools_tpu.formats.wav import WaveAudio
    from audiotools_tpu.formats.flac import FlacAudio
    from audiotools_tpu.parallel import farm

    log("phase 4: %d cards" % n_dev)
    check(len(jax.devices()) >= n_dev, "%d devices present" % n_dev)
    used = []
    calls = []
    analyze_q = flac_enc_fast._analyze_jax_q

    def spy(*args, **kwargs):
        handle = analyze_q(*args, **kwargs)
        used.append(handle.sharding)
        calls.append(inspect.signature(analyze_q).bind(*args, **kwargs))
        return handle

    def devices_used():
        ids = set()
        for sharding in used:
            ids |= {d.id for d in sharding.device_set}
        del used[:]
        return sorted(ids)

    flac_enc_fast._analyze_jax_q = spy
    try:
        opts = dict(bench.OPTS, batch_frames=sz["batch"])
        arr = bench.make_signal(BLOCK * sz["batch"] + 3000, seed=31)
        host = encode(arr, "numpy", **opts)
        os.environ["ATPU_DEVICES"] = str(n_dev)
        try:
            (dev, dt) = timed(encode, arr, "jax", **opts)
        finally:
            del os.environ["ATPU_DEVICES"]
        # the compiled program's input layout: the wire's block axis
        # split over the mesh, so each card analyzes its own blocks
        bound = calls[0].arguments
        wire = bound["wire"]
        fn = [f for (k, f) in flac_enc_fast._jax_analyze_cache.items()
              if k[0] == "q" and k[1] == wire.shape and k[15] == n_dev][0]
        wire_in = fn.lower(wire, bound["window"]).compile() \
            .input_shardings[0][0]
        log("  sharded encode: wire %s in as %r; decisions out as %s" %
            (wire.shape, wire_in, sorted({repr(s) for s in used})))
        check(tuple(wire_in.spec) == ("blocks",) and
              sorted(d.id for d in wire_in.device_set) ==
              list(range(n_dev)),
              "sharded encode splits each batch's blocks over devices "
              "0..%d" % (n_dev - 1))
        check(devices_used() == list(range(n_dev)),
              "sharded encode output spans devices 0..%d" % (n_dev - 1))
        check(dev == host, "%d-card sharded encode == numpy backend "
              "(%d bytes)" % (n_dev, len(host)))
        log("  info: sharded encode %.3f s incl. compile (%s)" %
            (dt, card))

        sources = []
        for i in range(sz["farm_tracks"]):
            path = os.path.join(tmp, "farm%d.wav" % i)
            WaveAudio.from_pcm(path, reader_for(bench.make_signal(
                SR * sz["farm_seconds"], seed=40 + i)))
            sources.append(path)

        def run_farm(label, shard):
            os.environ["ATPU_FARM_DEVICE_SHARD"] = "1" if shard else "0"
            try:
                jobs = [farm.FarmJob(path, os.path.join(
                            tmp, "%s%d.flac" % (label, i)), FlacAudio,
                            compression="8")
                        for (i, path) in enumerate(sources)]
                (results, dt) = timed(farm.transcode, jobs,
                                      workers=n_dev)
            finally:
                del os.environ["ATPU_FARM_DEVICE_SHARD"]
            for r in results:
                if not r.ok:
                    raise r.error
            outs = []
            for job in jobs:
                with open(job.dest_path, "rb") as f:
                    outs.append(f.read())
            ids = devices_used()
            log("  info: %s farm of %d tracks on devices %s: %.3f s "
                "(%s)" % (label, len(jobs), ids, dt, card))
            return (outs, ids)

        (one, ids_one) = run_farm("one", False)
        (many, ids_many) = run_farm("sharded", True)
        check(ids_one == [0], "one-card farm ran on device 0 alone")
        check(ids_many == list(range(n_dev)),
              "sharded farm ran on devices 0..%d" % (n_dev - 1))
        check(one == many, "%d-card farm outputs == one-card farm "
              "outputs (%d tracks)" % (n_dev, len(one)))
    finally:
        flac_enc_fast._analyze_jax_q = analyze_q
    for d in jax.devices()[:n_dev]:
        stats = d.memory_stats() or {}
        log("  device %d peak_bytes_in_use %s" %
            (d.id, stats.get("peak_bytes_in_use")))


# ---------------------------------------------------------------------


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--gpus", type=int, default=1, choices=(1, 4),
                        help="4: run only the four-card paths")
    args = parser.parse_args(argv)

    import jax
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print("chip_smoke: JAX's first device is %r, not a GPU; "
              "nothing was run" % (dev.platform,), file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, HERE)
    import audiotools_tpu  # noqa: F401  (fails outside the checkout)

    card = card_line()
    log("jax %s, %s x%d" % (jax.__version__, dev.device_kind,
                            len(devices)))
    log("card: %s" % card)
    sz = FULL
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if args.gpus == 4:
            phase_four(sz, card, tmp, 4)
        else:
            (arr, data) = phase_encode(sz, card, tmp)
            phase_decode(sz, card, tmp, arr, data)
            phase_converters(sz, card)
    log("all phases passed in %.1f s (%s)" % (time.perf_counter() - t0,
                                               card))
    print(json.dumps({"ok": True,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
