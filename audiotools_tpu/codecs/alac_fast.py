"""Fast ALAC codec: batched device LPC analysis + C++ adaptive emit.

The production ALAC path (reference counterpart
``/root/reference/src/encoders/alac.c`` / ``src/decoders/alac.c``).
ALAC's residual filter and Rice variant are adaptive recurrences
(host work by nature — see ``_native/hostkernels.cpp``); the batchable
front half (windowing, autocorrelation, Levinson-Durbin, coefficient
quantization for every block x group x leftweight x channel candidate)
runs through the shared contraction-immune kernels in
``ops/alac_frames.py`` — NumPy on host or jax.numpy on the device,
byte-identically.  The scalar oracle (``ref/alac.py``) shares the same
analysis kernel, so fast and oracle outputs are byte-identical.
"""

from __future__ import annotations

import os

import numpy as np

from .. import _native, pcm
from ..ops import alac_frames, lpc as lpc_ops, qpack
from ..ref import alac as oracle
from . import flac_enc_fast as flac_fast
from . import padgrid

_jax_alac_cache = {}


def _get_backend(backend):
    if backend is None:
        backend = (os.environ.get("ATPU_ALAC_BACKEND") or
                   os.environ.get("ATPU_FLAC_BACKEND"))
        if backend is None:
            from .flac_enc_fast import default_backend
            backend = default_backend()
    return backend


def _analyze(blocks, layout, bps, lsb_shift, interlacing_shift,
             min_lw, max_lw, window, backend):
    """packed LPC candidates [B, G, 5, 2, 15] for a uniform batch"""
    if backend == "jax":
        import jax
        jax.config.update("jax_enable_x64", True)
        from .flac_enc_fast import _enable_compilation_cache
        _enable_compilation_cache(jax)
        # ship int16 when the samples fit: half the upload bytes, and
        # the analysis widens on device
        if bps <= 16 and blocks.dtype != np.int16:
            blocks = blocks.astype(np.int16)
        key = (blocks.shape, blocks.dtype.str, tuple(layout), bps,
               lsb_shift, interlacing_shift, min_lw, max_lw)
        if key not in _jax_alac_cache:
            import jax.numpy as jnp

            def run(blocks, window):
                blocks = blocks.astype(jnp.int32)
                return alac_frames.analyze_framesets_packed(
                    jnp, blocks, list(layout), bps, lsb_shift,
                    interlacing_shift, min_lw, max_lw, window).ravel()
            _jax_alac_cache[key] = jax.jit(run)
        handle = _jax_alac_cache[key](blocks, window)
        try:
            handle.copy_to_host_async()
        except AttributeError:
            pass
        return handle
    else:
        return np.asarray(alac_frames.analyze_framesets_packed(
            np, blocks, list(layout), bps, lsb_shift,
            interlacing_shift, min_lw, max_lw, window))


def _analyze_q(wire, k, W, ch, layout, bps_eff, interlacing_shift,
               min_lw, max_lw, n, window):
    """jitted quantized-upload ALAC analysis (ops/qpack.py wire)

    wire: uint32 [B, ch*W + 2*ch] — bit-packed zigzag diffs of the
    LSB-shifted, quantized samples plus the bitcast int32 sideband
    [t(ch), x0(ch)].  The device reconstructs (x >> t) << t exactly
    and runs the same candidate program as the raw path with
    lsb_shift already applied — typically 2x (16-bit) to 4x (24-bit)
    fewer host->device bytes."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from .flac_enc_fast import _enable_compilation_cache
    _enable_compilation_cache(jax)
    key = ("q", wire.shape, k, W, ch, tuple(layout), bps_eff,
           interlacing_shift, min_lw, max_lw, n)
    if key not in _jax_alac_cache:
        import jax.numpy as jnp
        from jax import lax

        def run(wire, window):
            qwords = wire[:, :ch * W].reshape(-1, ch, W)
            meta = lax.bitcast_convert_type(wire[:, ch * W:],
                                            jnp.int32)
            t = meta[:, 0:ch]
            x0 = meta[:, ch:2 * ch]
            blocks = qpack.unpack(jnp, qwords, k, t, x0, n)
            return alac_frames.analyze_framesets_packed(
                jnp, blocks, list(layout), bps_eff, 0,
                interlacing_shift, min_lw, max_lw, window).ravel()
        _jax_alac_cache[key] = jax.jit(run)
    handle = _jax_alac_cache[key](wire, window)
    try:
        handle.copy_to_host_async()
    except AttributeError:
        pass
    return handle


def _bit_length(v):
    """vectorized int bit_length for non-negative int64 arrays"""
    v = np.asarray(v, dtype=np.int64)
    bl = np.zeros_like(v)
    vv = v.copy()
    for _ in range(63):
        live = vv > 0
        if not live.any():
            break
        bl += live
        vv >>= 1
    return bl


def _pick_scores(rows, min_lw, max_lw, width):
    """chosen leftweight, per-channel order/est, and group score from
    packed candidate rows [B, N_LEFTWEIGHTS, 2, COLS] — the emitter's
    (and oracle group_candidates'/pick_candidate's) policy batched"""
    B = rows.shape[0]
    if width == 1:
        lw_idx = np.zeros(B, dtype=np.int64)
        ch_rows = rows[:, 0, 0:1]                # [B, 1, COLS]
    else:
        ests = rows[:, min_lw:max_lw + 1, :, 13:15].astype(np.int64)
        score = ests.min(axis=3).sum(axis=2)     # [B, L]
        lw_idx = score.argmin(axis=1) + min_lw   # ties: lowest lw
        ch_rows = rows[np.arange(B), lw_idx]     # [B, 2, COLS]
    deg = ch_rows[..., 12] != 0
    est4 = ch_rows[..., 13].astype(np.int64)
    est8 = ch_rows[..., 14].astype(np.int64)
    order = np.where(deg | (est4 <= est8), 4, 8)
    est = np.where(order == 4, est4, est8)
    return (order, est, est.sum(axis=1))


def _floor_retry(packed, blocks, t_arr, layout, bps, lsb_shift,
                 interlacing_shift, min_lw, max_lw, window,
                 block_size):
    """applies the quantization-floor retry spec to a fetched batch

    Batched implementation of ref/alac.floor_limited + group_score:
    per (block, group), replicate the emitter's leftweight/order pick
    from the quantized estimates, flag groups whose chosen estimated
    mean |residual| sits ABOVE the quantization-step band
    (bits >= t + 2 — quantization hurt the fit; unpredictable content
    fits at <= t + 1 by the t plan), re-analyze the flagged groups
    exactly on host in one batched call, and keep whichever candidate
    set scores lower.  Chosen rows are overwritten in place; the
    emitter re-picks from the winning estimates, same as the oracle."""
    B = blocks.shape[0]
    bps_eff = bps - lsb_shift
    cap = max(bps_eff - qpack.cap_margin(), 0)
    for (g, (off, width)) in enumerate(layout):
        tg = t_arr[:B, off:off + width].max(axis=1).astype(np.int64)
        live = (tg > 0) & (tg < cap)   # capped t never flags (see
        if not live.any():             # ref/alac.floor_limited)
            continue
        rows = packed[:B, g]                     # [B, 5, 2, COLS]
        (order, est, score_q) = _pick_scores(rows, min_lw, max_lw,
                                             width)
        count = block_size - 1 - order
        # count <= 0 (block_size <= 9 at order 8): the oracle's
        # floor_limited skips such channels — never flag them
        safe = count > 0
        m_q = np.where(safe,
                       (est * 64) // np.maximum(count, 1), 0)
        cand = ((_bit_length(m_q) >= tg[:, None] + 2) &
                safe & live[:, None]).any(axis=1)  # [B]
        idx = np.nonzero(cand)[0]
        if not len(idx):
            continue
        exact = np.asarray(alac_frames.analyze_framesets_packed(
            np, blocks[idx], [layout[g]], bps, lsb_shift,
            interlacing_shift, min_lw, max_lw, window))[:, 0]
        (_oe, _ee, score_e) = _pick_scores(exact, min_lw, max_lw,
                                           width)
        better = score_e < score_q[idx]
        if better.any():
            if not packed.flags.writeable:  # jax fetches are read-only
                packed = packed.copy()
            packed[idx[better], g] = exact[better]
    return packed


def _fetch(handle, B, G):
    """materializes a packed analysis handle on host"""
    if isinstance(handle, np.ndarray):
        return handle
    import jax
    return np.asarray(jax.device_get(handle)).reshape(
        (B, G, alac_frames.N_LEFTWEIGHTS, 2, alac_frames.PACKED_COLS))


def encode_mdat_fast(file, pcmreader,
                     block_size=4096,
                     initial_history=10,
                     history_multiplier=40,
                     maximum_k=14,
                     interlacing_shift=2,
                     min_interlacing_leftweight=0,
                     max_interlacing_leftweight=4,
                     batch_frames=None,
                     backend=None):
    """writes an mdat atom from the PCMReader's data (fast path)

    returns (frame_byte_sizes, total_pcm_frames); byte-identical to
    ref.alac.encode_mdat by shared-kernel construction"""
    from ..pcmstream import BufferedPCMReader

    backend = _get_backend(backend)
    if batch_frames is None:
        # 256 amortizes per-dispatch cost and lands on the padgrid's
        # power-of-two shapes exactly
        batch_frames = int(os.environ.get(
            "ATPU_ALAC_BATCH", "256" if backend == "jax" else "16"))

    channels = pcmreader.channels
    bps = pcmreader.bits_per_sample
    layout = oracle.FRAMESET_LAYOUT.get(channels)
    if layout is None:
        raise ValueError("unsupported channel count")
    if bps > 16 and (bps - 16) % 8:
        # the LSB bypass stores whole BYTES (uncompressed_LSBs); a
        # shift of bps-16 with no byte to carry it would silently drop
        # bits (the oracle's uncompressed_LSBs = shift//8 semantics)
        raise ValueError(
            "bits_per_sample %d unsupported: bps - 16 must be a "
            "multiple of 8" % (bps,))
    lsb_shift = (bps - 16) if bps > 16 else 0
    bps_eff = bps - lsb_shift
    window = lpc_ops.tukey_window_df(block_size)
    # quantized-analysis upload (ops/qpack.py; scalar spec in
    # ref/alac.py qpack_enabled/plan_t/floor_limited).  The LSB shift
    # runs on host first, so the wire always carries <= 17-bit values
    # and the two-word format never overflows
    use_qpack = qpack.alac_enabled() and block_size > 2
    qguard = qpack.guard_bits()

    reader = BufferedPCMReader(pcmreader)
    total_pcm_frames = 0
    frame_byte_sizes = []

    mdat_start = file.tell()
    file.write(b"\x00" * 4 + b"mdat")

    def _pad_rows(arr):
        # pad partial batches up to the shared static shape grid
        # (codecs/padgrid.py, same scheme as flac_enc_fast
        #._pad_rows): fixed shapes bound jit recompiles to 4 per
        # (channels, bps) while short tracks stop paying
        # full-batch upload/device waste
        if backend == "jax" and arr.shape[0] < batch_frames:
            target = padgrid.target_rows(arr.shape[0], batch_frames)
            pad = target - arr.shape[0]
            arr = np.concatenate(
                [arr, np.zeros((pad,) + arr.shape[1:],
                               dtype=arr.dtype)])
        return arr

    def prepare(blocks, ns):
        """host half of a submission: the qpack scan + wire assembly
        (or the raw padded upload); returns (payload, blocks, ns, t)"""
        if use_qpack:
            shifted = blocks.astype(np.int32)
            if lsb_shift:
                shifted = shifted >> lsb_shift
            if backend == "jax":
                (qwords, k, t, x0, _orv, _cf) = _native.flac_qpack(
                    shifted, bps_eff, qguard, False)
                B = qwords.shape[0]
                W = qwords.shape[2]
                meta = np.concatenate([t, x0], axis=1).astype(np.int32)
                wire = _pad_rows(np.concatenate(
                    [qwords.reshape(B, -1), meta.view(np.uint32)],
                    axis=1))
                return (("q", wire, k, W), blocks, ns, t)
            t = qpack.plan_t(shifted, bps_eff, qguard)
            return (("np_q", qpack.quantize(np, shifted, t)),
                    blocks, ns, t)
        if backend == "jax":
            return (("raw", _pad_rows(blocks)), blocks, ns, None)
        return (("np", blocks), blocks, ns, None)

    # five-stage overlap (the FLAC pipeline shape): the main thread
    # reads and establishes order, a dispatcher thread owns
    # device_put + jit dispatch so reads never serialize behind the
    # device, a fetch POOL syncs device handles (transfers from
    # separate threads overlap, as in flac_enc_fast), an emit worker
    # runs the adaptive-entropy serializer (GIL-released), and the main
    # thread writes results in submission order.  Order is carried by
    # slot/event pairs enqueued to the emit stage before dispatch, so
    # pool completion order never matters.
    import queue as queue_mod
    import threading

    depth = max(int(os.environ.get("ATPU_ALAC_PIPELINE", "4")), 1)
    n_fetchers = (max(int(os.environ.get("ATPU_ALAC_FETCH_THREADS",
                                         "2")), 1)
                  if backend == "jax" else 1)
    dispatch_queue = queue_mod.Queue(maxsize=depth)
    emit_queue = queue_mod.Queue(maxsize=depth)
    fetch_queue = queue_mod.Queue()
    # unbounded: the in_flight counter already bounds results in
    # normal operation, and after a worker error the main thread stops
    # draining — a bounded queue would wedge the error-path drain
    result_queue = queue_mod.Queue()
    worker_error = []

    def dispatch_loop():
        while True:
            entry = dispatch_queue.get()
            if entry is None:
                for _ in range(n_fetchers):
                    fetch_queue.put(None)
                return
            (payload, slot, done) = entry
            if worker_error:
                done.set()
                continue
            try:
                tag = payload[0]
                if tag == "q":
                    (_tag, wire, k, W) = payload
                    handle = _analyze_q(
                        wire, k, W, channels, layout, bps_eff,
                        interlacing_shift,
                        min_interlacing_leftweight,
                        max_interlacing_leftweight, block_size,
                        window)
                    padded = wire.shape[0]
                elif tag == "np_q":
                    handle = np.asarray(
                        alac_frames.analyze_framesets_packed(
                            np, payload[1], list(layout), bps_eff, 0,
                            interlacing_shift,
                            min_interlacing_leftweight,
                            max_interlacing_leftweight, window))
                    padded = handle.shape[0]
                else:
                    upload = payload[1]
                    handle = _analyze(
                        upload, layout, bps, lsb_shift,
                        interlacing_shift,
                        min_interlacing_leftweight,
                        max_interlacing_leftweight,
                        lpc_ops.tukey_window_df(upload.shape[1]),
                        backend)
                    padded = upload.shape[0]
                if isinstance(handle, np.ndarray):
                    slot.append(handle)
                    done.set()
                else:
                    fetch_queue.put((handle, padded, slot, done))
            except BaseException as err:  # noqa: B902
                worker_error.append(err)
                done.set()

    def fetch_loop():
        while True:
            entry = fetch_queue.get()
            if entry is None:
                return
            (handle, padded, slot, done) = entry
            try:
                slot.append(_fetch(handle, padded, len(layout)))
            except BaseException as err:  # noqa: B902
                worker_error.append(err)
            finally:
                done.set()

    def emit_loop():
        while True:
            item = emit_queue.get()
            if item is None:
                return
            (slot, done, blocks, ns, t_arr) = item
            done.wait()
            if worker_error:
                result_queue.put(None)    # keep result slots aligned
                continue
            try:
                packed = np.asarray(slot[0]).reshape(
                    (-1, len(layout), alac_frames.N_LEFTWEIGHTS, 2,
                     alac_frames.PACKED_COLS))[:blocks.shape[0]]
                if t_arr is not None:
                    packed = _floor_retry(
                        np.ascontiguousarray(packed), blocks, t_arr,
                        layout, bps, lsb_shift, interlacing_shift,
                        min_interlacing_leftweight,
                        max_interlacing_leftweight, window,
                        block_size)
                result_queue.put(_native.alac_emit_framesets(
                    blocks, ns, layout, packed,
                    block_size, initial_history, history_multiplier,
                    maximum_k, interlacing_shift,
                    min_interlacing_leftweight,
                    max_interlacing_leftweight, bps))
            except BaseException as err:  # noqa: B902
                worker_error.append(err)
                result_queue.put(None)

    dispatcher = threading.Thread(target=dispatch_loop, daemon=True)
    dispatcher.start()
    fetchers = [threading.Thread(target=fetch_loop, daemon=True)
                for _ in range(n_fetchers)]
    for worker_thread in fetchers:
        worker_thread.start()
    worker = threading.Thread(target=emit_loop, daemon=True)
    worker.start()
    in_flight = 0

    def submit(blocks, ns):
        (payload, blocks, ns, t_arr) = prepare(blocks, ns)
        slot = []
        done = threading.Event()
        # emit first (establishes order), then the dispatcher
        emit_queue.put((slot, done, blocks, ns, t_arr))
        dispatch_queue.put((payload, slot, done))

    def drain_one():
        nonlocal in_flight
        result = result_queue.get()
        in_flight -= 1
        if worker_error:
            raise worker_error[0]
        (data, lens) = result
        file.write(data)
        frame_byte_sizes.extend(int(v) for v in lens)

    try:
        while True:
            framelist = reader.read(block_size * batch_frames)
            if framelist.frames == 0:
                break
            total_pcm_frames += framelist.frames
            samples = framelist.samples
            n_full = samples.shape[0] // block_size
            if n_full:
                blocks = np.ascontiguousarray(
                    samples[:n_full * block_size].reshape(
                        n_full, block_size, channels))
                submit(blocks,
                       np.full(n_full, block_size, dtype=np.int32))
                in_flight += 1
                while in_flight >= depth:
                    drain_one()
            tail = samples[n_full * block_size:]
            if tail.shape[0]:
                # zero-pad the tail to a full block for ANALYSIS (the
                # emitter codes only the true ns samples; the oracle
                # applies the same padded-analysis spec) so tails
                # reuse the steady-state compiled shape
                tail_blocks = np.zeros((1, block_size, channels),
                                       dtype=np.int32)
                tail_blocks[0, :tail.shape[0]] = tail
                submit(tail_blocks,
                       np.asarray([tail.shape[0]], dtype=np.int32))
                in_flight += 1
        while in_flight > 0:
            drain_one()
    finally:
        dispatch_queue.put(None)
        dispatcher.join()
        for worker_thread in fetchers:
            worker_thread.join()
        emit_queue.put(None)
        worker.join()

    end = file.tell()
    file.seek(mdat_start)
    file.write((sum(frame_byte_sizes) + 8).to_bytes(4, "big"))
    file.seek(end)

    return (frame_byte_sizes, total_pcm_frames)


class FastALACDecoder(oracle.ALACDecoder):
    """PCMReader-compatible ALAC decoder over the native kernels

    atom parsing stays in Python (inherited); frameset decode runs in
    C++ (``_native.atpu_alac_decode``) over buffered mdat bytes."""

    CHUNK_BYTES = 0x200000

    def __init__(self, file_or_path):
        oracle.ALACDecoder.__init__(self, file_or_path)
        self._buffer = b""
        self._remaining = self.total_pcm_frames
        self._eof = False
        # byte offset of the first frameset (reader sits there after
        # the parent's atom walk) for stsz-table seeking
        self._mdat_offset = self.reader.source.tell()
        self._frame_sizes = None

    def _read_frame_sizes(self):
        """parses the stsz sample-size table (frameset byte sizes)"""
        if self._frame_sizes is not None:
            return self._frame_sizes
        pos = self.reader.source.tell()
        try:
            self.reader.source.seek(0)
            stsz = self._find_sub_atom(b"moov", b"trak", b"mdia",
                                       b"minf", b"stbl", b"stsz")
            (_version_flags, fixed_size,
             count) = stsz.parse("32u 32u 32u")
            if fixed_size:
                self._frame_sizes = [fixed_size] * count
            else:
                self._frame_sizes = [stsz.read(32)
                                     for _ in range(count)]
        except (IOError, KeyError, ValueError):
            self._frame_sizes = []
        finally:
            self.reader.source.seek(pos)
            self.reader.byte_align()
        return self._frame_sizes

    def seekable(self):
        return True

    def seek(self, pcm_frame):
        """seeks to the given PCM frame position

        returns the frameset-aligned position actually seeked to
        (at or before the requested frame), using the M4A stsz table
        (role of reference src/decoders/alac.c seeking)"""
        sizes = self._read_frame_sizes()
        target = max(min(int(pcm_frame), self.total_pcm_frames), 0)
        index = min(target // self.samples_per_frame,
                    max(len(sizes) - 1, 0)) if sizes else 0
        offset = sum(sizes[:index])
        self.reader.source.seek(self._mdat_offset + offset)
        self.reader.byte_align()
        self._buffer = b""
        self._eof = False
        position = index * self.samples_per_frame
        self._remaining = self.total_pcm_frames - position
        return position

    def read(self, pcm_frames):
        if self._remaining <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        while len(self._buffer) < self.CHUNK_BYTES and not self._eof:
            # read the byte-aligned source directly: read_bytes raises
            # (and discards the partial tail) on short reads
            chunk = self.reader.source.read(
                self.CHUNK_BYTES - len(self._buffer))
            if not chunk:
                self._eof = True
                break
            self._buffer += chunk

        want = min(max(pcm_frames, self.samples_per_frame),
                   self._remaining)
        (samples, consumed) = _native.alac_decode(
            self._buffer, self.bits_per_sample, self.channels,
            self.samples_per_frame, self.initial_history,
            self.history_multiplier, self.maximum_k, want)
        if samples.shape[0] == 0 and self._remaining > 0:
            if self._eof and consumed == 0:
                raise IOError("truncated ALAC stream")
        self._buffer = self._buffer[consumed:]
        self._remaining -= samples.shape[0]
        return pcm.FrameList._wrap(np.ascontiguousarray(samples),
                                   self.bits_per_sample)
