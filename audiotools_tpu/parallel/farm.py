"""Threaded transcode farm: many tracks through one warm device session.

Reference counterpart: ``track2track``'s fork-per-track worker queue
(``/root/reference/audiotools/__init__.py`` ExecProgressQueue,
``/root/reference/trackverify:104-215``) — re-designed for a device.
Forked workers would each pay a fresh jax import, XLA executable load
and first-dispatch warmup, and each would open the card again, so the
farm instead runs a small THREAD pool inside one process: every
worker shares the same warm jit cache and device session, the device
waits of different tracks overlap each other, and the host
stages (source decode, frame emit, verification decode, AccurateRip)
ride under other tracks' device waits — the native kernels all
release the GIL.

Each job is transcode + verify in one pass: the destination is decoded
ONCE after encoding (the decoder's end-of-stream MD5 check is exactly
``trackverify``'s lossless check) and an optional ``post`` hook runs
any further per-track oracle work (AccurateRip CRCs, comparisons)
inside the worker thread.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading


class FarmJob:
    """one transcode task: source AudioFile/path -> dest file

    source        : AudioFile instance, or a path string opened via
                    dispatch.open()
    dest_path     : output filename
    dest_class    : AudioFile subclass to encode as
    compression   : compression level string (or None for default)
    post          : optional callable(dest_audiofile) -> object, run in
                    the worker thread after a successful encode; its
                    return value lands in FarmResult.post
    """

    def __init__(self, source, dest_path, dest_class,
                 compression=None, post=None, metadata=None):
        self.source = source
        self.dest_path = dest_path
        self.dest_class = dest_class
        self.compression = compression
        self.post = post
        self.metadata = metadata


class FarmResult:
    def __init__(self, job, dest=None, error=None, post=None):
        self.job = job
        self.dest = dest          # destination AudioFile (on success)
        self.error = error        # exception (on failure)
        self.post = post          # post-hook return value

    @property
    def ok(self):
        return self.error is None


def default_workers():
    """farm width: enough threads that device waits overlap

    workers spend much of their wall time blocked on the device or in
    GIL-released native kernels, so more threads than cores can pay
    (ATPU_FARM_WORKERS overrides)."""
    return int(os.environ.get("ATPU_FARM_WORKERS", "6"))


def device_shard_enabled():
    """whether farm workers pin round-robin to mesh devices

    ATPU_FARM_DEVICE_SHARD=1 turns the farm into per-device batch
    queues: worker w dispatches its tracks' analysis batches to
    jax device w mod D, so independent tracks ride different chips
    concurrently (track-level data parallelism over the mesh — the
    device replacement for the reference's fork-per-track
    ExecProgressQueue when more than one chip is attached)."""
    return os.environ.get("ATPU_FARM_DEVICE_SHARD", "0") == "1"


def transcode(jobs, workers=None, progress=None, devices=None):
    """runs FarmJobs through a thread pool; returns FarmResults

    results are in job order.  A failed job carries its exception in
    .error (it is not raised: remaining tracks still transcode, like
    the reference queue).  ``progress(done_count, total)`` is called
    after each completion from worker threads.

    devices: optional explicit jax device list for per-worker pinning
    (defaults to jax.devices() when device_shard_enabled())."""
    from .. import dispatch

    jobs = list(jobs)
    if workers is None:
        workers = default_workers()
    workers = max(min(workers, len(jobs)), 1)

    if devices is None and device_shard_enabled():
        try:
            import jax
            devices = jax.devices()
        except Exception:
            devices = None

    results = [None] * len(jobs)
    work = queue_mod.Queue()
    for item in enumerate(jobs):
        work.put(item)
    done_count = [0]
    done_lock = threading.Lock()

    def run_job(job):
        source = job.source
        if isinstance(source, str):
            source = dispatch.open(source)
        reader = source.to_pcm()
        try:
            kwargs = {}
            if job.compression is not None:
                kwargs["compression"] = job.compression
            dest = job.dest_class.from_pcm(
                job.dest_path, reader, **kwargs)
        finally:
            reader.close()
        if job.metadata is not None:
            dest.set_metadata(job.metadata)
        post = job.post(dest) if job.post is not None else None
        return FarmResult(job, dest=dest, post=post)

    def worker(worker_index):
        if devices:
            # pin this worker's jit dispatches to one mesh device
            from ..codecs import flac_enc_fast
            flac_enc_fast.set_thread_device(
                devices[worker_index % len(devices)])
        while True:
            try:
                (idx, job) = work.get_nowait()
            except queue_mod.Empty:
                return
            try:
                results[idx] = run_job(job)
            except BaseException as err:  # noqa: B902
                try:
                    os.unlink(job.dest_path)   # no partial outputs
                except OSError:
                    pass
                results[idx] = FarmResult(job, error=err)
            if progress is not None:
                with done_lock:
                    done_count[0] += 1
                    progress(done_count[0], len(jobs))

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def verify_flac(dest, chunk=65536, accuraterip=None):
    """decode-once verification for a freshly written FLAC file

    returns the decoded samples as an int32 [frames, channels] array;
    raises on any stream error or STREAMINFO MD5 mismatch (the
    decoder checks the hash at end of stream — the same check
    ``trackverify`` performs).

    accuraterip: optional (is_first, is_last) pair; when given (and
    the stream is CD-format stereo 16-bit) the AccurateRip V1/V2 CRCs
    are folded into the same decode pass and the return value becomes
    (samples, (v1, v2))."""
    import numpy as np

    crc = None
    if accuraterip is not None:
        from ..accuraterip_checksum import AccurateRipCRC
        (is_first, is_last) = accuraterip
        crc = AccurateRipCRC(is_first, is_last, dest.sample_rate(),
                             dest.total_frames())

    reader = dest.to_pcm()
    out = []
    try:
        while True:
            framelist = reader.read(chunk)
            if framelist.frames == 0:
                break
            out.append(framelist.samples)
            if crc is not None:
                crc.update_array(framelist.samples)
    finally:
        reader.close()
    if out:
        samples = np.concatenate(out)
    else:
        samples = np.zeros((0, dest.channels()), dtype=np.int32)
    if crc is not None:
        return (samples, crc.checksums())
    return samples
