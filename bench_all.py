"""Benchmarks for every BASELINE.md config (1-5).

`bench.py` is the driver's single-metric harness (config 2 only);
this script measures all five working-baseline configs and prints one
JSON line per config, in one process (which holds the card).  Run on
the GPU:

    python bench_all.py

Configs (BASELINE.md):
  1. FLAC decode -> PCM (MD5-verified), realtime-x
  2. FLAC -8 encode, bit-exact, Msamples/s        (same as bench.py)
  3. ALAC + WavPack round trips incl. 6ch / 8-bit edge cases
  4. Polyphase resample 96k->44.1k + ReplayGain title/album gain
  5. Transcode farm: SHN/TTA/WavPack -> FLAC with trackverify
     (decode + AccurateRip), bit-exact rate
"""

import io
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from audiotools_tpu import pcm  # noqa: E402
from audiotools_tpu.pcmstream import (PCMReader, pcm_frame_cmp)  # noqa: E402

SR = 44100


def emit(config, metric, value, unit, extra=None):
    row = {"config": config, "metric": metric,
           "value": round(value, 3), "unit": unit}
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)


def make_signal(n_frames, channels=2, bps=16, seed=7, rate=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames)
    amp = (1 << (bps - 1)) * 0.28
    base = np.stack(
        [amp * np.sin(2 * np.pi * (300 + 67 * c) * t / rate) +
         rng.normal(0, amp / 16, n_frames)
         for c in range(channels)], axis=1)
    lim = (1 << (bps - 1)) - 1
    return np.clip(base, -lim - 1, lim).astype(np.int32)


def reader_for(arr, bps=16, rate=SR):
    (n, ch) = arr.shape
    masks = {1: 0x4, 2: 0x3, 6: 0x3F}
    fl = pcm.FrameList._wrap(arr, bps)
    return PCMReader(io.BytesIO(fl.to_bytes(False, True)),
                     rate, ch, masks.get(ch, 0), bps)


def drain(reader, chunk=65536):
    out = []
    while True:
        fl = reader.read(chunk)
        if fl.frames == 0:
            break
        out.append(fl.samples)
    return np.concatenate(out) if out else np.zeros((0, 1), np.int32)


def config1_flac_decode():
    from audiotools_tpu.codecs.flac_enc_fast import encode_flac_fast
    from audiotools_tpu.codecs.flac_dec_fast import FastFlacDecoder

    arr = make_signal(SR * 120)
    buf = io.BytesIO()
    encode_flac_fast(buf, reader_for(arr), max_lpc_order=12,
                     max_residual_partition_order=6, mid_side=True,
                     exhaustive_model_search=True, backend="numpy")
    data = buf.getvalue()
    # steady-state methodology (same as configs 2/5): one warm pass,
    # then best-of-3 (host scheduler noise swings single passes)
    drain(FastFlacDecoder(io.BytesIO(data)))
    dt = None
    for _trial in range(3):
        t0 = time.perf_counter()
        got = drain(FastFlacDecoder(io.BytesIO(data)))
        trial_dt = time.perf_counter() - t0
        dt = trial_dt if dt is None else min(dt, trial_dt)
    ok = np.array_equal(got, arr)
    emit(1, "flac_decode_realtime_x",
         (arr.shape[0] / SR) / dt if ok else 0.0, "x",
         {"bit_exact": bool(ok),
          "Msamples_per_sec": round(arr.size / dt / 1e6, 1)})

    # device path (ATPU_FLAC_DEC_BACKEND=jax): host structural scan +
    # batched Rice decode and synthesis on the accelerator
    # (codecs/flac_dec_jax.py); byte-identical output, measured
    # separately.  A failure here raises: no 0-valued row stands in
    from audiotools_tpu.codecs.flac_dec_jax import JaxFlacDecoder
    short = data if arr.shape[0] <= SR * 30 else None
    if short is None:
        arr2 = arr[:SR * 30]
        buf2 = io.BytesIO()
        encode_flac_fast(buf2, reader_for(np.ascontiguousarray(arr2)),
                         max_lpc_order=12,
                         max_residual_partition_order=6,
                         mid_side=True, exhaustive_model_search=True,
                         backend="numpy")
        short = buf2.getvalue()
        arr2 = np.asarray(arr2)
    else:
        arr2 = arr
    got2 = drain(JaxFlacDecoder(io.BytesIO(short)))   # warm/compile
    t0 = time.perf_counter()
    got2 = drain(JaxFlacDecoder(io.BytesIO(short)))
    dt2 = time.perf_counter() - t0
    ok2 = np.array_equal(got2, arr2)
    emit(1, "flac_decode_jax_realtime_x",
         (arr2.shape[0] / SR) / dt2 if ok2 else 0.0, "x",
         {"bit_exact": bool(ok2),
          "Msamples_per_sec": round(arr2.size / dt2 / 1e6, 2)})


def config3_alac_wavpack():
    from audiotools_tpu.formats.m4a import ALACAudio
    from audiotools_tpu.formats.wavpack import WavPackAudio
    import tempfile

    base_cases = [("stereo16", make_signal(SR * 30, 2, 16), 16),
                  ("6ch16", make_signal(SR * 10, 6, 16), 16)]
    # ALAC is 16/24-bit only (reference m4a.py gating); WavPack takes
    # the 8-bit edge case from BASELINE config 3
    per_class = {
        "alac": base_cases + [("24bit",
                               make_signal(SR * 10, 2, 24, seed=9),
                               24)],
        "wavpack": base_cases + [("8bit",
                                  make_signal(SR * 10, 2, 8, seed=9),
                                  8)],
    }
    for (cls, name) in ((ALACAudio, "alac"), (WavPackAudio, "wavpack")):
        cases = per_class[name]
        total = 0
        t_enc = t_dec = 0.0
        ok = True
        with tempfile.TemporaryDirectory() as td:
            # warm each (channels, bps) program class outside the timed
            # region (same methodology as bench.py / config 5: one
            # short encode per class loads the XLA executable onto the
            # device; a steady-state library session pays this once per
            # process, not per file)
            for (label, arr, bps) in cases:
                wpath = os.path.join(td,
                                     "warm_" + label + "." + cls.SUFFIX)
                cls.from_pcm(wpath,
                             reader_for(arr[:SR * 2], bps)).to_pcm()
            for (label, arr, bps) in cases:
                # best-of-2 per case (scheduler noise)
                best_enc = best_dec = None
                for rep in range(2):
                    path = os.path.join(
                        td, "%s_%d.%s" % (label, rep, cls.SUFFIX))
                    t0 = time.perf_counter()
                    f = cls.from_pcm(path, reader_for(arr, bps))
                    enc = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    mismatch = pcm_frame_cmp(f.to_pcm(),
                                             reader_for(arr, bps))
                    dec = time.perf_counter() - t0
                    ok = ok and (mismatch is None)
                    best_enc = enc if best_enc is None else \
                        min(best_enc, enc)
                    best_dec = dec if best_dec is None else \
                        min(best_dec, dec)
                t_enc += best_enc
                t_dec += best_dec
                total += arr.size
        emit(3, name + "_roundtrip_Msamples_per_sec",
             total / (t_enc + t_dec) / 1e6 if ok else 0.0,
             "Msamples/s",
             {"bit_exact": bool(ok),
              "encode_Msps": round(total / t_enc / 1e6, 1),
              "decode_Msps": round(total / t_dec / 1e6, 1)})

    # steady-state ALAC encode (the numbers above average SHORT edge
    # cases, which pay per-file pipeline ramp; a 2-minute stream shows
    # the sustained pipeline rate)
    from audiotools_tpu.codecs.alac_fast import encode_mdat_fast
    arr = make_signal(SR * 120, 2, 16)
    best = None
    for _rep in range(3):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        encode_mdat_fast(buf, reader_for(arr))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    emit(3, "alac_steady_encode_Msamples_per_sec",
         arr.size / best / 1e6, "Msamples/s")


def config4_resample_replaygain():
    from audiotools_tpu.pcmconverter import Resampler
    from audiotools_tpu.replaygain import ReplayGain

    arr = make_signal(96000 * 30, 2, 16, rate=96000)
    dt_rs = None
    for _trial in range(3):             # best-of-3: host-CPU path
        t0 = time.perf_counter()
        out = drain(Resampler(reader_for(arr, rate=96000), SR))
        trial = time.perf_counter() - t0
        dt_rs = trial if dt_rs is None else min(dt_rs, trial)

    rg = ReplayGain(SR)
    dt_rg = None
    for _trial in range(3):
        t0 = time.perf_counter()
        (gain, peak) = rg.title_gain(reader_for(out[:SR * 30]))
        trial = time.perf_counter() - t0
        dt_rg = trial if dt_rg is None else min(dt_rg, trial)
    emit(4, "resample_96k_to_44k_Msamples_per_sec",
         arr.size / dt_rs / 1e6, "Msamples/s",
         {"replaygain_Msamples_per_sec":
          round(out[:SR * 30].size / dt_rg / 1e6, 1),
          "title_gain_dB": round(float(gain), 2),
          "peak": round(float(peak), 4)})

    # device backends (ops/converters.py): resampler FIR, ReplayGain
    # FIR-ized equal-loudness analysis, AccurateRip uint32-lattice
    # MACs — each env-gated, measured against the same inputs.  A
    # failure here raises: no 0-valued row stands in
    os.environ["ATPU_RESAMPLE_BACKEND"] = "jax"
    os.environ["ATPU_RG_BACKEND"] = "jax"
    os.environ["ATPU_AR_BACKEND"] = "jax"
    try:
        drain(Resampler(reader_for(arr, rate=96000), SR))  # warm jit
        dt_rsd = None
        for _trial in range(3):
            t0 = time.perf_counter()
            out_d = drain(Resampler(reader_for(arr, rate=96000), SR))
            trial = time.perf_counter() - t0
            dt_rsd = trial if dt_rsd is None else min(dt_rsd, trial)
        max_dev = int(np.abs(out_d.astype(np.int64) -
                             out.astype(np.int64)).max())
        rg2 = ReplayGain(SR)
        rg2.title_gain(reader_for(out[:SR * 2]))           # warm jit
        dt_rgd = None
        for _trial in range(3):
            rg3 = ReplayGain(SR)
            t0 = time.perf_counter()
            (gain_d, peak_d) = rg3.title_gain(
                reader_for(out[:SR * 30]))
            trial = time.perf_counter() - t0
            dt_rgd = trial if dt_rgd is None else min(dt_rgd, trial)
        from audiotools_tpu.accuraterip_checksum import (
            accuraterip_checksums)
        track = make_signal(SR * 60, 2, 16)
        os.environ["ATPU_AR_BACKEND"] = ""
        cs_host = accuraterip_checksums(reader_for(track),
                                        track.shape[0], True, True)
        os.environ["ATPU_AR_BACKEND"] = "jax"
        accuraterip_checksums(reader_for(track[:SR]), SR,
                              True, True)                  # warm jit
        dt_ar = None
        for _trial in range(3):
            t0 = time.perf_counter()
            cs_dev = accuraterip_checksums(
                reader_for(track), track.shape[0], True, True)
            trial = time.perf_counter() - t0
            dt_ar = trial if dt_ar is None else min(dt_ar, trial)
        emit(4, "resample_device_Msamples_per_sec",
             arr.size / dt_rsd / 1e6, "Msamples/s",
             {"max_lsb_delta_vs_host": max_dev,
              "replaygain_device_Msamples_per_sec":
              round(out[:SR * 30].size / dt_rgd / 1e6, 1),
              "rg_gain_delta_dB":
              round(abs(float(gain_d) - float(gain)), 4),
              "accuraterip_device_Msamples_per_sec":
              round(track.size / dt_ar / 1e6, 1),
              "accuraterip_match_host": bool(cs_dev == cs_host)})
    finally:
        for key in ("ATPU_RESAMPLE_BACKEND", "ATPU_RG_BACKEND",
                    "ATPU_AR_BACKEND"):
            os.environ.pop(key, None)


def config5_transcode_farm():
    from audiotools_tpu.formats.shn import ShortenAudio
    from audiotools_tpu.formats.tta import TrueAudio
    from audiotools_tpu.formats.wavpack import WavPackAudio
    from audiotools_tpu.formats.flac import FlacAudio
    from audiotools_tpu.accuraterip_checksum import (
        accuraterip_checksums)
    from audiotools_tpu.parallel import farm
    import tempfile

    n_tracks = 6
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(dir=shm) as td:
        sources = []
        for i in range(n_tracks):
            arr = make_signal(SR * 20, 2, 16, seed=100 + i)
            cls = (ShortenAudio, TrueAudio, WavPackAudio)[i % 3]
            path = os.path.join(td, "src%d.%s" % (i, cls.SUFFIX))
            cls.from_pcm(path, reader_for(arr))
            # the expected AccurateRip CRCs play the database's role
            # (the reference's accuraterip_lookup queries a remote DB;
            # computing the expected entry isn't part of the rip)
            crc_ref = accuraterip_checksums(
                reader_for(arr), arr.shape[0], True, True)
            sources.append((path, cls, arr, crc_ref))

        def make_post(arr, crc_ref):
            # per-track oracle, run in the worker thread: ONE decode
            # pass covering the decoder's EOF MD5 check
            # (trackverify's lossless check) with the AccurateRip
            # V1/V2 CRCs folded in, then sample equality vs the source
            def post(dest):
                (got, crc_got) = farm.verify_flac(
                    dest, accuraterip=(True, True))
                return bool(np.array_equal(got, arr) and
                            crc_ref == crc_got)
            return post

        total = sum(arr.size for (_, _, arr, _) in sources)
        # one full-length warm-up encode loads the XLA executable onto
        # the device and exercises the same batch shape + wire width
        # as the real tracks (once per process — steady-state farms
        # keep a warm session, same methodology as bench.py's
        # steady-state window)
        FlacAudio.from_pcm(os.path.join(td, "warm.flac"),
                           reader_for(make_signal(SR * 20, 2, 16,
                                                  seed=99)),
                           compression="8")
        # two timed passes, best taken: the first still absorbs
        # one-time session effects (branchy code paths, allocator),
        # and the steady state is what a long-running farm sees
        best = None
        for rep in range(2):
            jobs = [farm.FarmJob(cls(path),
                                 os.path.join(td, "out%d_%d.flac"
                                              % (rep, i)),
                                 FlacAudio, compression="8",
                                 post=make_post(arr, crc_ref))
                    for (i, (path, cls, arr, crc_ref))
                    in enumerate(sources)]
            t0 = time.perf_counter()      # farm time excludes setup
            results = farm.transcode(jobs)
            dt = time.perf_counter() - t0
            exact = sum(1 for r in results if r.ok and r.post)
            if best is None or dt < best[0]:
                best = (dt, exact)
        (dt, exact) = best
    emit(5, "transcode_farm_Msamples_per_sec",
         total / dt / 1e6, "Msamples/s",
         {"bit_exact_rate": exact / n_tracks,
          "tracks": n_tracks})
    if os.environ.get("ATPU_BENCH_BUDGET") == "1":
        _config5_budget()


def _config5_budget():
    """per-stage serial budget for the farm pipeline (one pass per
    stage over the same corpus shapes): where config 5's wall goes.
    Stages: source decode (SHN/TTA/WV native
    kernels), FLAC -8 encode (device path), verify decode + MD5,
    AccurateRip."""
    from audiotools_tpu.formats.shn import ShortenAudio
    from audiotools_tpu.formats.tta import TrueAudio
    from audiotools_tpu.formats.wavpack import WavPackAudio
    from audiotools_tpu.formats.flac import FlacAudio
    from audiotools_tpu.accuraterip_checksum import (
        accuraterip_checksums)
    from audiotools_tpu.parallel import farm
    import tempfile

    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    rows = {}
    with tempfile.TemporaryDirectory(dir=shm) as td:
        sources = []
        for i in range(6):
            arr = make_signal(SR * 20, 2, 16, seed=100 + i)
            cls = (ShortenAudio, TrueAudio, WavPackAudio)[i % 3]
            path = os.path.join(td, "b%d.%s" % (i, cls.SUFFIX))
            cls.from_pcm(path, reader_for(arr))
            sources.append((path, cls, arr))
        total = sum(arr.size for (_, _, arr) in sources)

        t0 = time.perf_counter()
        for (path, cls, _arr) in sources:
            drain(cls(path).to_pcm())
        rows["source_decode"] = time.perf_counter() - t0

        outs = []
        for (rep, (path, cls, _arr)) in enumerate(sources):
            FlacAudio.from_pcm(os.path.join(td, "w%d.flac" % rep),
                               reader_for(make_signal(SR, 2, 16)),
                               compression="8")
            break                      # warm once
        t0 = time.perf_counter()
        for (i, (path, cls, _arr)) in enumerate(sources):
            out = os.path.join(td, "bo%d.flac" % i)
            reader = cls(path).to_pcm()
            FlacAudio.from_pcm(out, reader, compression="8")
            reader.close()
            outs.append(out)
        rows["decode_plus_encode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for out in outs:
            farm.verify_flac(FlacAudio(out))
        rows["verify_decode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for (_path, _cls, arr) in sources:
            accuraterip_checksums(reader_for(arr), arr.shape[0],
                                  True, True)
        rows["accuraterip"] = time.perf_counter() - t0

    budget = {k: round(v, 3) for (k, v) in rows.items()}
    budget["encode_only_est"] = round(
        rows["decode_plus_encode"] - rows["source_decode"], 3)
    emit(5, "transcode_farm_budget_seconds", round(sum(
        rows.values()), 3), "s",
        dict(budget, corpus_Msamples=round(total / 1e6, 1)))


def config2_flac_encode():
    """bench.py's measurement, run in this process (one process holds
    the card): the default wire, then the ATPU_PALLAS=1 variant
    (device residual packing + host emit splice, exact uploads)"""
    import contextlib
    import bench

    for (variant, env) in ((None, {}),
                           ("device_pack", {"ATPU_PALLAS": "1",
                                            "ATPU_FLAC_QPACK": "0"})):
        saved = {key: os.environ.get(key) for key in env}
        os.environ.update(env)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                rc = bench.main()
        finally:
            for (key, value) in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        if rc != 0:
            raise RuntimeError("bench.py failed (variant %s)" % variant)
        row = json.loads(out.getvalue().strip().splitlines()[-1])
        row["config"] = 2
        if variant is not None:
            row["variant"] = variant
        print(json.dumps(row), flush=True)


def main():
    config1_flac_decode()
    config2_flac_encode()
    config3_alac_wavpack()
    config4_resample_replaygain()
    config5_transcode_farm()


if __name__ == "__main__":
    sys.exit(main() or 0)
