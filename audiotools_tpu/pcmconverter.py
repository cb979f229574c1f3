"""PCM converter suite: channel mixing, resampling, bit-depth changes.

Rebuild of the reference converter stack
(``/root/reference/src/pcmconverter.c``, ``src/dither.c``,
``src/samplerate/``):

* Averager (pcmconverter.c:64-94): n-channel average with C-style
  truncating integer division
* Downmixer (pcmconverter.c:220-330): 6-channel -> stereo matrix with
  0.7 center gain, 0.6 rear gain and half-away-from-zero rounding
* Resampler: polyphase windowed-sinc FIR interpolation.  The reference
  vendors libsamplerate (SRC_SINC_BEST_QUALITY, pcmconverter.c:395)
  whose best-quality coefficient table is stripped from the source
  tree; this implementation derives an equivalent Kaiser-windowed
  sinc bank at runtime, so output is functionally (not bit-)
  equivalent.  The kernel evaluation is a batched FIR suited to the
  device path (matmul over a [frames, taps] window matrix).
* BPSConverter (pcmconverter.c:667-760): bit-depth changes via shifts;
  reductions XOR a 1-bit white dither into the LSB like the reference
"""

from __future__ import annotations

import os

import numpy as np

from . import pcm
from .pcmstream import ChannelMask


class Averager:
    """averages a multi-channel stream into a single channel"""

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = 1
        self.channel_mask = 0x4
        self.bits_per_sample = pcmreader.bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        acc = frame.samples.astype(np.int64).sum(axis=1)
        # C-style truncation toward zero
        out = (np.sign(acc) *
               (np.abs(acc) // frame.channels)).astype(np.int32)
        return pcm.FrameList._wrap(out.reshape(-1, 1),
                                   self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


class Downmixer:
    """downmixes a 3-6 channel stream to stereo"""

    REAR_GAIN = 0.6
    CENTER_GAIN = 0.7

    def __init__(self, pcmreader):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = 2
        self.channel_mask = 0x3
        self.bits_per_sample = pcmreader.bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        n = frame.frames

        input_mask = int(self.pcmreader.channel_mask)
        if input_mask == 0:
            input_mask = {0: 0x0, 1: 0x4, 2: 0x3, 3: 0x7, 4: 0x33,
                          5: 0x37, 6: 0x3F}.get(
                              self.pcmreader.channels, 0x3F)

        # distribute source channels into the 6 standard slots
        six = np.zeros((n, 6), dtype=np.float64)
        channel = 0
        for (slot, mask) in enumerate([0x1, 0x2, 0x4, 0x8, 0x10, 0x20]):
            if mask & input_mask:
                if channel < frame.channels:
                    six[:, slot] = frame.samples[:, channel]
                channel += 1

        sample_min = -(1 << (self.bits_per_sample - 1))
        sample_max = (1 << (self.bits_per_sample - 1)) - 1

        mono_rear = 0.7 * (six[:, 4] + six[:, 5])
        left = (six[:, 0] + self.REAR_GAIN * mono_rear +
                self.CENTER_GAIN * six[:, 2])
        right = (six[:, 1] - self.REAR_GAIN * mono_rear +
                 self.CENTER_GAIN * six[:, 2])

        # C round(): half away from zero
        def c_round(x):
            return np.sign(x) * np.floor(np.abs(x) + 0.5)

        out = np.stack([
            np.clip(c_round(left), sample_min, sample_max),
            np.clip(c_round(right), sample_min, sample_max)],
            axis=1).astype(np.int32)
        return pcm.FrameList._wrap(out, self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


def _kaiser_sinc_kernel(phase, taps, cutoff, beta=14.0):
    """evaluates a Kaiser-windowed sinc kernel at the given fractional
    phase; returns [len(phase), taps] float64 coefficients"""
    half = taps // 2
    k = np.arange(-half + 1, half + 1, dtype=np.float64)  # [taps]
    x = k[None, :] - phase[:, None]                       # [M, taps]
    sinc = cutoff * np.sinc(cutoff * x)
    # Kaiser window evaluated over the kernel support
    w_arg = x / half
    w_arg = np.clip(w_arg, -1.0, 1.0)
    window = np.i0(beta * np.sqrt(1.0 - w_arg * w_arg)) / np.i0(beta)
    return sinc * window


class Resampler:
    """a PCMReader wrapper which converts sample rates

    polyphase windowed-sinc interpolation with streaming overlap.
    The 512-tap Kaiser(beta=16) prototype matches the reference's
    SRC_SINC_BEST_QUALITY tier (src_sinc.c:1207): passband ripple
    under 0.001 dB to 0.9x the output Nyquist and >140 dB stopband
    once the transition band closes (verified by
    tests/test_resampler_quality.py)."""

    TAPS = 512
    BETA = 16.0

    def __init__(self, pcmreader, sample_rate):
        self.pcmreader = pcmreader
        self.sample_rate = sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = pcmreader.bits_per_sample

        self.__input_rate__ = pcmreader.sample_rate
        ratio = sample_rate / pcmreader.sample_rate
        self.__cutoff__ = min(1.0, ratio) * 0.9475
        half = self.TAPS // 2
        # history holds the trailing input context across reads
        self.__history__ = np.zeros((0, self.channels),
                                    dtype=np.float64)
        self.__consumed__ = 0          # input frames fully consumed
        self.__next_out__ = 0          # next output frame index
        self.__eof__ = False
        self.__half__ = half

        # polyphase filter bank: for a rational rate change the
        # fractional phase cycles through num/den residues, so the
        # Kaiser-sinc kernel (a Bessel evaluation per tap) is
        # computed once per distinct phase instead of once per
        # output sample; irrational-looking pairs fall back to a
        # dense quantized bank
        from fractions import Fraction
        from math import gcd
        g = gcd(self.__input_rate__, sample_rate)
        num = self.__input_rate__ // g
        den = sample_rate // g
        self.__step_num__ = num
        self.__step_den__ = den
        if den <= 8192:
            self.__bank_den__ = den
        else:
            self.__bank_den__ = 8192
        phases = np.arange(self.__bank_den__,
                           dtype=np.float64) / self.__bank_den__
        self.__bank__ = _kaiser_sinc_kernel(phases, self.TAPS,
                                            self.__cutoff__,
                                            beta=self.BETA)

    def read(self, pcm_frames):
        from fractions import Fraction
        half = self.__half__
        step = Fraction(self.__input_rate__, self.sample_rate)

        # pull enough input to produce pcm_frames outputs
        needed_end = (self.__next_out__ + max(pcm_frames, 1)) * step
        while (not self.__eof__ and
               (self.__consumed__ + len(self.__history__) <
                int(needed_end) + half + 2)):
            chunk = self.pcmreader.read(max(pcm_frames, 4096))
            if chunk.frames == 0:
                self.__eof__ = True
                break
            scale = 1 << (self.bits_per_sample - 1)
            self.__history__ = np.concatenate(
                [self.__history__,
                 chunk.samples.astype(np.float64) / scale], axis=0)

        # determine how many outputs are producible
        available = self.__consumed__ + len(self.__history__)
        if self.__eof__:
            # total outputs = floor(total_input * out/in)
            total_out = int(available * Fraction(
                self.sample_rate, self.__input_rate__))
            max_out = min(self.__next_out__ + pcm_frames, total_out)
        else:
            max_out = self.__next_out__ + pcm_frames

        out_indices = np.arange(self.__next_out__, max_out)
        if len(out_indices) == 0:
            return pcm.empty_framelist(self.channels,
                                       self.bits_per_sample)

        # input positions for each output frame (exact rational
        # arithmetic: position i = i*num/den)
        num = self.__step_num__
        den = self.__step_den__
        scaled = out_indices * num
        base = scaled // den
        phase_num = scaled - base * den         # phase = k/den

        # pad history at the edges for window overlap (stream head
        # and tail only; mid-stream reads skip the copy)
        hist_start = self.__consumed__
        lo = base - half + 1 - hist_start
        pad_left = max(0, -int(lo.min()))
        pad_right = max(0, int(lo.max()) + self.TAPS -
                        len(self.__history__))
        if pad_left or pad_right:
            padded = np.pad(self.__history__,
                            [(pad_left, pad_right), (0, 0)])
        else:
            padded = self.__history__
        starts = lo + pad_left

        if self.__bank_den__ == den:
            q = phase_num                              # exact
        else:
            q = ((phase_num * self.__bank_den__ + den // 2) //
                 den) % self.__bank_den__              # quantized
        bank = self.__bank__
        from .ops import converters as _conv
        if _conv.resample_backend() == "jax":
            # device FIR (north-star device converter suite); matches
            # the host kernel within 1 LSB (f64 sums in another order):
            # see tests/test_converters_device.py
            out = _conv.resample_fir_device(padded, starts,
                                            q.astype(np.int32), bank)
        else:
            try:
                from . import _native
                out = _native.resample_fir(padded, starts,
                                           q.astype(np.int32), bank)
            except ImportError:
                # accumulate one tap at a time: 1-D row gathers + an
                # outer-product add vectorize well, where a single
                # [M, taps, ch] gather does not
                out = np.zeros((len(starts), self.channels),
                               dtype=np.float64)
                for t in range(self.TAPS):
                    out += padded[starts + t] * bank[q, t][:, None]

        self.__next_out__ = int(max_out)

        # drop history no longer needed
        keep_from = int(base.min()) - half - 2 - hist_start
        if keep_from > 0:
            self.__history__ = self.__history__[keep_from:]
            self.__consumed__ += keep_from

        return pcm.FloatFrameList._wrap(out).to_int(
            self.bits_per_sample)

    def close(self):
        self.pcmreader.close()


class BPSConverter:
    """a PCMReader wrapper which converts bits-per-sample via shifts"""

    def __init__(self, pcmreader, bits_per_sample):
        self.pcmreader = pcmreader
        self.sample_rate = pcmreader.sample_rate
        self.channels = pcmreader.channels
        self.channel_mask = pcmreader.channel_mask
        self.bits_per_sample = bits_per_sample

    def read(self, pcm_frames):
        frame = self.pcmreader.read(pcm_frames)
        old = self.pcmreader.bits_per_sample
        new = self.bits_per_sample
        if new < old:
            shift = old - new
            # white 1-bit dither XOR'd into the LSB (reference
            # pcmconverter.c:695-700)
            dither_bytes = np.frombuffer(
                os.urandom(frame.samples.size), dtype=np.uint8)
            dither = (dither_bytes & 1).astype(np.int32).reshape(
                frame.samples.shape)
            out = (frame.samples >> shift) ^ dither
        elif new > old:
            out = frame.samples << (new - old)
        else:
            out = frame.samples
        return pcm.FrameList._wrap(out.astype(np.int32), new)

    def close(self):
        self.pcmreader.close()
