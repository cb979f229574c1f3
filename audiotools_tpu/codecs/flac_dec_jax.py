"""Device (JAX) FLAC decoder: batched Rice decode + fused synthesis.

The device decode path (``ATPU_FLAC_DEC_BACKEND=jax``), the
counterpart of reference ``src/decoders/flac.c:174-260,1156-1193``
redesigned per SURVEY.md §7 step 5:

* host: ``_native.atpu_flac_scan`` walks frame/subframe structure
  (CRC-verified) and records residual-partition bit spans — the
  byte-serial part of decode, kept on host like the encode side's
  emitters,
* device (one jit per shape signature): partitions Rice-decode in
  batch via the pointer-doubling state machine (ops/rice_decode.py),
  scatter into subframe planes, the predictor recurrences run as ONE
  fused ``lax.scan`` seeded from the bitstream's warm-up samples
  (ops/flac_synth.py), wasted-bits/stereo/interleave reconstruct
  full frames,
* host: per-frame trim + the spec's stream MD5 (order-dependent,
  SURVEY.md §5) folded by the native MD5 kernel.

Output is byte-identical to the host decoder (FastFlacDecoder) and
the oracle (ref/flac_dec.py); streams with pathological partitions
(bit spans beyond the largest device bucket) fall back to the host
decoder per chunk.
"""

from __future__ import annotations

import numpy as np

from .. import _native, pcm
from ..ops import flac_synth, rice_decode
from .flac_dec_fast import FastFlacDecoder

# frames per device batch (shape-padded; see _pad_frames).  Wide
# batches are the decode scans' main lever: the per-op cost of a
# lock-step scan step is nearly lane-count-independent, so more
# partition/subframe lanes per step amortize it (word-level tables
# keep the footprint linear in W, not N)
MAX_BATCH_FRAMES = 1024
# residual-run chunking: the host scan walks every Rice code anyway
# (unary lengths are data-dependent), so it checkpoints each run
# every CHUNK codes for free — the device then decodes C/CHUNK
# INDEPENDENT lanes of CHUNK codes instead of one C-long sequential
# partition (a -8 porder-0 stereo batch becomes ~128k lanes x 64
# steps instead of ~2k lanes x 4096 steps; the lock-step scan's
# per-step cost is lane-width-independent, so wall drops ~CHUNK/C)
import os as _os
CHUNK_CODES = int(_os.environ.get("ATPU_FLAC_DEC_CHUNK", "64"))
# partition capacity per scan call (worst sane case: 8 ch x
# 4096/CHUNK records per subframe at the standard -8 block size,
# plus one alignment break per subframe)
MAX_PARTS = MAX_BATCH_FRAMES * 8 * 66
# partition buckets: (window words, max codes). A partition lands in
# the smallest bucket holding both its bit span and its code count.
# With chunking, spans concentrate at CHUNK * (k + 2) bits — the
# graded 64-code buckets keep padding tight across k; the monster
# bucket remains the catch-all (pathological unary runs, CHUNK=0)
BUCKETS = ((8, 64), (16, 64), (32, 64), (64, 64), (2048, 4096))

_jit_cache = {}


def _pad_rows(k):
    """next power of two >= k (min 8) — bounds jit signatures"""
    p = 8
    while p < k:
        p <<= 1
    return p


def _get_decode_jit(key):
    """builds (or returns) the jitted batch decoder for a static shape
    signature: (n, ch, S_pad, F_pad, ((W, C, P_pad), ...))"""
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from .flac_enc_fast import _enable_compilation_cache
    _enable_compilation_cache(jax)   # shape signatures persist

    (n, ch, S_pad, F_pad, buckets, Kw, narrow, use_i32,
     aligned) = key

    def run(words, sub_args, frame_assignment, bucket_args):
        (warmup, qlp, shift, order, wasted, const_val,
         is_const) = sub_args
        if aligned:
            # aligned-slot assembly: the chunker breaks every record
            # at destination multiples of CHUNK_CODES, so no record
            # CROSSES a slot boundary — a leading-axis row scatter
            # replaces the per-element general scatter.  Several
            # records may still SHARE one slot (partition boundaries
            # land mid-slot when psize is not a slot multiple, e.g.
            # block 192 porder 1), each covering a disjoint sub-range
            # and zero elsewhere, so rows scatter-ADD rather than set
            CH = CHUNK_CODES
            slots = n // CH
            plane2 = jnp.zeros((S_pad * slots, CH), dtype=jnp.int32)
            for ((W, C, _), args) in zip(buckets, bucket_args):
                (word_base, base_bits, k, raw_bits, count,
                 sub_idx, dest_off) = args
                vals = rice_decode.decode_partitions_auto(
                    jnp, words, word_base, base_bits, k, raw_bits,
                    count, W, C)[:, :CH]
                off = (dest_off % CH)[:, None]
                cidx = jnp.arange(CH, dtype=jnp.int32)[None, :]
                src = jnp.clip(cidx - off, 0, CH - 1)
                row = jnp.where(
                    (cidx >= off) & (cidx < off + count[:, None]),
                    jnp.take_along_axis(vals, src, axis=1), 0)
                slot = sub_idx * slots + dest_off // CH
                slot = jnp.where(count > 0, slot, S_pad * slots)
                plane2 = plane2.at[slot].add(row, mode="drop")
            planes = plane2.reshape(S_pad, n)
        else:
            planes = jnp.zeros((S_pad, n), dtype=jnp.int32)
            for ((W, C, _), args) in zip(buckets, bucket_args):
                (word_base, base_bits, k, raw_bits, count,
                 sub_idx, dest_off) = args
                vals = rice_decode.decode_partitions_auto(
                    jnp, words, word_base, base_bits, k, raw_bits,
                    count, W, C)
                planes = planes + rice_decode.scatter_residuals(
                    jnp, vals, sub_idx, dest_off, count, S_pad, n, C)
        samples = flac_synth.synthesize(
            jnp, planes, warmup, qlp, shift, order, n,
            use_i32=use_i32)
        # CONSTANT subframes fill directly (they participate in
        # stereo decorrelation, so this happens before reconstruct)
        samples = jnp.where(is_const[:, None], const_val[:, None],
                            samples)
        out = flac_synth.reconstruct_frames(
            jnp, samples, wasted, frame_assignment, ch)
        if narrow:
            # bps <= 16 streams fit int16: halves the device->host
            # PCM transfer
            out = out.astype(jnp.int16)
        return out

    fn = jax.jit(run)
    _jit_cache[key] = fn
    return fn


# compressed bytes buffered per device decode batch: enough to feed
# full MAX_BATCH_FRAMES batches (a -8 stereo 4096-block frame is
# ~4-12 KB) — the device path's throughput lever is batch width, so
# it decodes AHEAD of the caller's read size and serves from a PCM
# buffer (a 262144-frame FRAMELIST_SIZE request would otherwise make
# 64-block batches, each paying a dispatch and a transfer)
DEVICE_CHUNK_BYTES = 0x800000


class JaxFlacDecoder(FastFlacDecoder):
    """a PCMReader decoding FLAC on the device path

    Inherits STREAMINFO/seektable parsing, buffering, seek() and the
    EOF MD5 check from the host decoder; read() decodes
    MAX_BATCH_FRAMES-deep batches through the scan + device pipeline
    and serves the caller from the decoded-PCM buffer (never more
    than requested, so seek()'s discard loop keeps its contract)."""

    _pcm_buf = None
    _pcm_off = 0
    _inflight = None

    def read(self, pcm_frames):
        if self.closed:
            raise ValueError("stream is closed")
        if (self._pcm_buf is None or
                self._pcm_off >= self._pcm_buf.shape[0]):
            if self.eof:
                return pcm.empty_framelist(self.channels,
                                           self.bits_per_sample)
            fallback = self._fill_pcm_buffer(pcm_frames)
            if fallback is not None:
                return fallback     # host-path / EOF framelist
            if (self._pcm_buf is None or
                    self._pcm_off >= self._pcm_buf.shape[0]):
                return pcm.empty_framelist(self.channels,
                                           self.bits_per_sample)
        buf = self._pcm_buf
        take = min(buf.shape[0] - self._pcm_off,
                   max(int(pcm_frames), 1))
        chunk = np.ascontiguousarray(
            buf[self._pcm_off:self._pcm_off + take])
        self._pcm_off += take
        framelist = pcm.FrameList._wrap(chunk, self.bits_per_sample)
        self.decoded_frames += take
        if (self._pcm_off >= buf.shape[0] and self.total_frames and
                self.decoded_frames >= self.total_frames):
            self._finish()
        return framelist

    def seek(self, pcm_frame):
        self._pcm_buf = None
        self._pcm_off = 0
        self._inflight = None       # dispatched PCM is pre-seek data
        return FastFlacDecoder.seek(self, pcm_frame)

    def _fill_pcm_buffer(self, pcm_frames):
        """decodes one device batch into the PCM buffer; returns None
        on success, or a framelist when the host path must serve the
        request (pathological layouts) / the stream finished.

        DOUBLE-BUFFERED: one dispatched batch stays in flight, and
        the NEXT batch is scanned + dispatched before the in-flight
        batch's PCM is fetched — the device executes batch i+1 under
        batch i's device->host transfer (jit dispatch is async).  The
        MD5 folds at fetch time, preserving stream order; fallback
        and terminal paths only run with no batch in flight."""
        if self._inflight is None:
            st = self._start_batch(pcm_frames, allow_terminal=True)
            if not (isinstance(st, tuple) and st[0] == "dev"):
                return st           # framelist (fallback/EOF)
            self._inflight = st[1]
        # line the next batch up on the device before fetching
        nxt = self._start_batch(pcm_frames, allow_terminal=False)
        (handle, meta) = self._inflight
        samples = self._finish_batch(handle, meta)
        self._inflight = (nxt[1] if isinstance(nxt, tuple) and
                          nxt[0] == "dev" else None)
        self.current_md5.update_pcm(samples, self.bits_per_sample)
        self._pcm_buf = samples
        self._pcm_off = 0
        return None

    def _start_batch(self, pcm_frames, allow_terminal):
        """scans + dispatches one batch; returns ("dev", (handle,
        meta)) on success.  With allow_terminal, may instead return a
        served framelist (host fallback / EOF / corrupt-stream
        error); otherwise terminal conditions DEFER (return None
        without consuming) so the caller handles them on the next
        fill with no batch in flight."""
        file_exhausted = False
        if len(self.buffer) - self.buf_off < DEVICE_CHUNK_BYTES:
            if self.buf_off:
                del self.buffer[:self.buf_off]
                self.buf_off = 0
            while len(self.buffer) < DEVICE_CHUNK_BYTES:
                chunk = self.file.read(DEVICE_CHUNK_BYTES)
                if not chunk:
                    file_exhausted = True
                    break
                self.buffer += chunk

        if self.buf_off >= len(self.buffer):
            if not allow_terminal:
                return None
            self._finish()
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        view = memoryview(self.buffer)[self.buf_off:]
        max_batch = MAX_BATCH_FRAMES * max(
            self.maximum_block_size or 65536, 4096)
        try:
            scan = _native.flac_scan(
                view, self.bits_per_sample, self.channels,
                max_samples=max_batch,
                max_frames=MAX_BATCH_FRAMES,
                max_parts=MAX_PARTS,
                chunk_codes=CHUNK_CODES)
        except _native.CapacityError:
            # pathological partition layout: host path for this chunk
            if not allow_terminal:
                return None
            return super().read(pcm_frames)

        if scan["consumed_bytes"] == 0:
            if not allow_terminal:
                return None
            if not file_exhausted:
                chunk = self.file.read(DEVICE_CHUNK_BYTES)
                if chunk:
                    self.buffer += chunk
                    return self._start_batch(pcm_frames,
                                             allow_terminal=True)
            if (len(self.buffer) - self.buf_off > 0 and
                    (not self.total_frames or
                     self.decoded_frames < self.total_frames)):
                raise ValueError(
                    "corrupt FLAC stream: undecodable bytes at "
                    "frame %d" % (self.decoded_frames,))
            self._finish()
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        try:
            dispatched = self._decode_batch(scan, bytes(view))
        except _OverflowsBuckets:
            if not allow_terminal:
                return None
            return super().read(pcm_frames)

        self.buf_off += scan["consumed_bytes"]
        return ("dev", dispatched)

    def _decode_batch(self, scan, data):
        """dispatches one scanned batch to the device pipeline
        (ASYNC: the jit call returns a device handle immediately);
        returns (handle, trim_meta) for _finish_batch"""
        frame_meta = scan["frame_meta"]
        sub_meta = scan["sub_meta"]
        part_meta = scan["part_meta"]
        F = frame_meta.shape[0]
        ch = self.channels
        n = int(frame_meta[:, 0].max())
        F_pad = _pad_rows(F)
        S_pad = F_pad * ch

        # ---- subframe arrays (host prep, numpy) ----
        S = sub_meta.shape[0]
        # static coefficient width on the {8, 16, 32} grid: the
        # synthesis scan's per-step MAC width (order <= 12 at -8, so
        # most batches run at 16 instead of 32)
        max_order = int(sub_meta[:, 2].max()) if S else 0
        Kw = 8
        while Kw < max_order:
            Kw <<= 1
        Kw = min(Kw, flac_synth.K)
        warmup = np.zeros((S_pad, Kw), dtype=np.int32)
        qlp = np.zeros((S_pad, Kw), dtype=np.int32)
        shift = np.zeros(S_pad, dtype=np.int32)
        order = np.zeros(S_pad, dtype=np.int32)
        wasted = np.zeros(S_pad, dtype=np.int32)
        const_val = np.zeros(S_pad, dtype=np.int32)
        is_const = np.zeros(S_pad, dtype=bool)
        warmup[:S] = scan["warmup"][:, :Kw]
        qlp[:S] = flac_synth.fill_fixed_qlp(sub_meta,
                                            scan["qlp"])[:, :Kw]
        shift[:S] = sub_meta[:, 4]
        order[:S] = sub_meta[:, 2]
        wasted[:S] = sub_meta[:, 3]
        const_val[:S] = sub_meta[:, 6]
        is_const[:S] = sub_meta[:, 1] == 0
        assignment = np.zeros(F_pad, dtype=np.int32)
        assignment[:F] = frame_meta[:, 1]
        # int16 transfer when every decoded sample provably fits
        # (bps + wasted <= 16 on every subframe of a <= 16-bit
        # stream)
        narrow = bool(self.bits_per_sample <= 16 and
                      int(frame_meta[:, 2].max()) <= 16)
        # native-int32 synthesis whenever no intermediate can wrap
        # for this batch's coefficients/shifts (else the exact-f64
        # scan)
        vbits = np.zeros(S_pad, dtype=np.int32)
        vbits[:S] = sub_meta[:, 5] + 1          # ebps value bound
        use_i32 = flac_synth.i32_synthesis_safe(qlp, shift, vbits)

        # ---- partition bucketing ----
        bit_off = part_meta[:, 5]
        bit_len = part_meta[:, 6]
        count = part_meta[:, 2]
        word_base = bit_off >> 5
        base_bits = bit_off & 31
        w_need = (base_bits + bit_len + 31) >> 5
        bucket_rows = []
        assigned = np.zeros(part_meta.shape[0], dtype=bool)
        for (W, C) in BUCKETS:
            sel = (~assigned) & (w_need <= W) & (count <= C)
            bucket_rows.append(np.nonzero(sel)[0])
            assigned |= sel
        if not assigned.all():
            raise _OverflowsBuckets()

        words = rice_decode.bytes_to_words(
            data[:scan["consumed_bytes"]])

        bucket_shapes = []
        bucket_args = []
        for ((W, C), rows) in zip(BUCKETS, bucket_rows):
            if len(rows) == 0:
                continue
            P_pad = _pad_rows(len(rows))
            pm = part_meta[rows]

            def padded(v, fill=0):
                out = np.full(P_pad, fill, dtype=np.int32)
                out[:len(rows)] = v
                return out

            bucket_shapes.append((W, C, P_pad))
            bucket_args.append((
                padded(word_base[rows]),
                padded(base_bits[rows]),
                padded(pm[:, 3], -1),
                # padding rows decode as 0-width raw runs of count 0
                padded(pm[:, 4], 0),
                padded(pm[:, 2]),
                padded(pm[:, 0], S_pad - 1),
                padded(pm[:, 1]),
            ))

        # aligned-slot assembly applies when the chunker's alignment
        # invariant holds: every record fits one CHUNK-wide slot
        # (chunking on, n a slot multiple — the chunker breaks at
        # destination multiples of CHUNK_CODES)
        aligned = bool(
            CHUNK_CODES > 0 and n % CHUNK_CODES == 0 and
            bool((((part_meta[:, 1] % CHUNK_CODES) + count) <=
                  CHUNK_CODES).all()))
        key = (n, ch, S_pad, F_pad, tuple(bucket_shapes), Kw, narrow,
               use_i32, aligned)
        fn = _get_decode_jit(key)
        handle = fn(words,
                    (warmup, qlp, shift, order, wasted,
                     const_val, is_const),
                    assignment, tuple(bucket_args))
        return (handle, (narrow, F, n, ch, frame_meta[:, 0].copy()))

    @staticmethod
    def _finish_batch(handle, meta):
        """fetches a dispatched batch's PCM (blocks on exec +
        transfer) and trims per-frame"""
        (narrow, F, n, ch, block_sizes) = meta
        out = np.asarray(handle)
        if narrow:
            out = out.astype(np.int32)
        if (block_sizes == n).all():
            return out[:F].reshape(F * n, ch)
        pieces = [out[f, :block_sizes[f], :] for f in range(F)]
        return np.concatenate(pieces, axis=0)


class _OverflowsBuckets(Exception):
    """a partition exceeded the largest device bucket"""
