"""Device (JAX) ALAC decoder: host entropy scan + fused adaptive
predictor scan.

The ALAC sibling of codecs/flac_dec_jax.py (reference
``src/decoders/alac.c``), split per the established decode design:

* host: ``_native.atpu_alac_scan`` walks framesets and decodes the
  history-adaptive entropy half (bit positions are data-dependent —
  inherently byte-serial), exporting residual planes + predictor
  metadata + LSB planes,
* device (one jit per shape signature): the sign-adaptive predictor
  recurrence runs as ONE fused ``lax.scan`` over sample positions for
  all subframes together (ops/alac_synth.py), followed by interlaced
  stereo decorrelation and LSB re-attachment as vector ops,
* host: wave-order channel interleave + per-frameset trim.

Output is byte-identical to the host decoder (FastALACDecoder) and
the oracle (ref/alac.py); enabled with ``ATPU_ALAC_DEC_BACKEND=jax``.
Subframes with order > 8 (not produced by this framework's encoder
but legal ALAC) fall back to the host decoder per chunk.
"""

from __future__ import annotations

import numpy as np

from .. import _native, pcm
from ..ops import alac_synth
from .alac_fast import FastALACDecoder

# framesets per device batch (shape-padded)
MAX_BATCH_FRAMESETS = 64
MAX_ORDER = 8

_jit_cache = {}


def _pad_rows(k, floor=8):
    p = floor
    while p < k:
        p <<= 1
    return p


def _get_synth_jit(key):
    """jitted batch program: predictor scan + decorrelation + LSB
    merge for a static (S_pad, G_pad, n) signature"""
    if key in _jit_cache:
        return _jit_cache[key]
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from .flac_enc_fast import _enable_compilation_cache
    _enable_compilation_cache(jax)

    (S_pad, G_pad, n) = key

    def run(residuals, qlp, order, shift, sample_size, is_raw,
            ch0_idx, ch1_idx, lweight, ishift, lsb_bits, lsbs):
        synth = alac_synth.synthesize(
            jnp, residuals, qlp, order, shift, sample_size, n,
            max_order=MAX_ORDER)
        synth = jnp.where(is_raw[:, None], residuals, synth)
        ch0 = synth[ch0_idx]                    # [G, n]
        ch1 = synth[ch1_idx]
        (left, right) = alac_synth.decorrelate(
            jnp, ch0, ch1, lweight, ishift)
        left = alac_synth.merge_lsbs(jnp, left, lsbs[:, :, 0],
                                     lsb_bits)
        right = alac_synth.merge_lsbs(jnp, right, lsbs[:, :, 1],
                                      lsb_bits)
        return (left, right)

    _jit_cache[key] = jax.jit(run)
    return _jit_cache[key]


class JaxALACDecoder(FastALACDecoder):
    """a PCMReader decoding ALAC on the device path

    Inherits atom parsing, buffering, stsz seeking and trim handling
    from the host decoder; read() routes frameset decoding through
    the scan + device pipeline."""

    def read(self, pcm_frames):
        if self._remaining <= 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        while len(self._buffer) < self.CHUNK_BYTES and not self._eof:
            chunk = self.reader.source.read(
                self.CHUNK_BYTES - len(self._buffer))
            if not chunk:
                self._eof = True
                break
            self._buffer += chunk

        want = min(max(pcm_frames, self.samples_per_frame),
                   self._remaining)
        spf = self.samples_per_frame
        max_framesets = min(
            MAX_BATCH_FRAMESETS,
            -(-want // spf) if spf else 1)
        scan = _native.alac_scan(
            self._buffer, self.bits_per_sample, self.channels,
            spf, self.initial_history, self.history_multiplier,
            self.maximum_k,
            max_framesets * spf,
            max_framesets * self.channels + self.channels)
        if scan["total_frames"] <= 0:
            # nothing scanned (short tail buffer): host decoder path
            return FastALACDecoder.read(self, pcm_frames)
        compressed = scan["sub_meta"][:, 6] == 0
        if ((scan["sub_meta"][:, 2] > MAX_ORDER).any() or
                (compressed & (scan["sub_meta"][:, 3] < 1)).any()):
            # order > 8 (legal ALAC, not produced here) or shift 0
            # (UB in the C reference): host decoder handles the chunk
            return FastALACDecoder.read(self, pcm_frames)

        samples = self._decode_batch(scan)
        self._buffer = self._buffer[scan["consumed_bytes"]:]
        if samples.shape[0] > self._remaining:
            samples = samples[:self._remaining]
        self._remaining -= samples.shape[0]
        return pcm.FrameList._wrap(
            np.ascontiguousarray(samples), self.bits_per_sample)

    def _decode_batch(self, scan):
        spf = self.samples_per_frame
        sub_meta = scan["sub_meta"]
        pair_meta = scan["pair_meta"]
        S = sub_meta.shape[0]
        G = pair_meta.shape[0]
        S_pad = _pad_rows(S)
        G_pad = _pad_rows(G)

        def pad(a, rows, fill=0):
            if a.shape[0] == rows:
                return a
            out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
            out[:a.shape[0]] = a
            return out

        residuals = pad(scan["residuals"], S_pad)
        qlp = pad(scan["qlp"], S_pad)[:, :alac_synth.K]
        order = pad(sub_meta[:, 2], S_pad)
        shift = pad(np.maximum(sub_meta[:, 3], 1), S_pad, fill=1)
        sample_size = pad(np.maximum(sub_meta[:, 4], 1), S_pad,
                          fill=1)
        is_raw = pad(sub_meta[:, 6], S_pad) != 0

        # per-pair subframe rows: pair g's channels are the scan's
        # consecutive subframe rows (chan_in_pair 0/1; single-channel
        # pairs reuse row 0 for ch1 — decorrelate passes through)
        ch0_idx = np.zeros(G_pad, dtype=np.int32)
        ch1_idx = np.zeros(G_pad, dtype=np.int32)
        row = 0
        for g in range(G):
            width = int(pair_meta[g, 1])
            ch0_idx[g] = row
            ch1_idx[g] = row + (1 if width == 2 else 0)
            row += width
        lweight = pad(pair_meta[:, 4], G_pad)
        ishift = pad(np.maximum(pair_meta[:, 3], 1), G_pad, fill=1)
        lsb_bits = pad(pair_meta[:, 2] * 8, G_pad)
        lsbs = pad(scan["lsbs"], G_pad)

        import jax
        fn = _get_synth_jit((S_pad, G_pad, spf))
        (left, right) = jax.device_get(fn(
            residuals, qlp, order.astype(np.int32),
            shift.astype(np.int32), sample_size.astype(np.int32),
            is_raw, ch0_idx, ch1_idx, lweight.astype(np.int32),
            ishift.astype(np.int32), lsb_bits.astype(np.int32),
            lsbs))
        left = np.asarray(left)
        right = np.asarray(right)

        # wave-order interleave per frameset (host, cheap)
        from ..ref.alac import WAVE_ORDER
        order_tbl = WAVE_ORDER.get(self.channels)
        fs_count = scan["fs_count"]
        total = int(fs_count.sum())
        out = np.empty((total, self.channels), dtype=np.int32)
        # group pairs by frameset
        pos = 0
        pair_by_fs = {}
        for g in range(G):
            pair_by_fs.setdefault(int(pair_meta[g, 6]), []).append(g)
        for (fs, count) in enumerate(fs_count):
            count = int(count)
            chans = [None] * self.channels
            for g in pair_by_fs.get(fs, ()):
                base = int(pair_meta[g, 0])
                width = int(pair_meta[g, 1])
                chans[base] = left[g]
                if width == 2:
                    chans[base + 1] = right[g]
            for c in range(self.channels):
                src = chans[order_tbl[c]]
                out[pos:pos + count, c] = src[:count]
            pos += count
        return out
