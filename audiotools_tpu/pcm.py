"""PCM data plane: FrameList / FloatFrameList.

Batched redesign of the reference's C FrameList type
(``/root/reference/src/pcm.c:117`` and ``:952``): instead of a C array of
ints with scalar (de)interleave loops, samples live in a NumPy
``int32[frames, channels]`` array that converts zero-copy to a JAX device
array.  Byte pack/unpack (8/16/24-bit LE/BE, signed/unsigned) is expressed
as vectorized NumPy view/shift operations rather than per-sample loops.

API parity targets (reference ``src/pcm.c:69-102``):
  FrameList(data, channels, bits_per_sample, is_big_endian, is_signed)
  .frames .channels .bits_per_sample  len() == frames*channels
  [i] -> int sample (interleaved), frame(i), channel(c), split(i),
  to_bytes(is_big_endian, is_signed), to_float(), frame_count(bytes),
  concatenation (+), repetition (*), equality
  classmethods: from_list (src/pcm.c:651), from_frames (:722),
  from_channels (:807)
  FloatFrameList mirror with to_int(bps) (src/pcm.c:1199-1227).
"""

from __future__ import annotations

import numpy as np

# the C++ data-plane kernels handle bulk byte conversion when available
try:
    from . import _native as _native_pcm
except Exception:          # pragma: no cover - build failure fallback
    _native_pcm = None

__all__ = [
    "FrameList",
    "FloatFrameList",
    "from_list",
    "from_frames",
    "from_channels",
    "from_float_frames",
    "from_float_channels",
    "empty_framelist",
]


def _unpack_bytes(data, channels, bits_per_sample, is_big_endian, is_signed):
    """bytes -> int32[frames, channels] (always signed internally)."""
    if bits_per_sample not in (8, 16, 24):
        raise ValueError("unsupported bits per sample")
    if channels < 1:
        raise ValueError("channel count must be > 0")
    bytes_per_sample = bits_per_sample // 8
    frame_bytes = bytes_per_sample * channels
    if len(data) % frame_bytes:
        raise ValueError(
            "number of bytes %d not divisible by frame size %d" %
            (len(data), frame_bytes))
    if _native_pcm is not None:
        return _native_pcm.unpack_pcm(
            data, bits_per_sample, is_big_endian,
            is_signed).reshape(-1, channels)
    raw = np.frombuffer(data, dtype=np.uint8)
    n_samples = len(data) // bytes_per_sample
    b = raw.reshape(n_samples, bytes_per_sample).astype(np.uint32)
    if is_big_endian:
        b = b[:, ::-1]
    # little-endian accumulate
    value = np.zeros(n_samples, dtype=np.uint32)
    for i in range(bytes_per_sample):
        value |= b[:, i] << (8 * i)
    if is_signed:
        # sign-extend from bits_per_sample
        sign = np.uint32(1 << (bits_per_sample - 1))
        out = value.astype(np.int64)
        out = np.where(value & sign, out - (1 << bits_per_sample), out)
    else:
        out = value.astype(np.int64) - (1 << (bits_per_sample - 1))
    return out.astype(np.int32).reshape(-1, channels)


def _pack_bytes(samples, bits_per_sample, is_big_endian, is_signed):
    """int32[frames, channels] -> bytes."""
    if _native_pcm is not None:
        return _native_pcm.pack_pcm(samples, bits_per_sample,
                                    is_big_endian, is_signed)
    bytes_per_sample = bits_per_sample // 8
    flat = samples.reshape(-1).astype(np.int64)
    if not is_signed:
        flat = flat + (1 << (bits_per_sample - 1))
    u = (flat & ((1 << bits_per_sample) - 1)).astype(np.uint32)
    out = np.empty((len(u), bytes_per_sample), dtype=np.uint8)
    for i in range(bytes_per_sample):
        shift = 8 * i
        col = i if not is_big_endian else bytes_per_sample - 1 - i
        out[:, col] = (u >> shift) & 0xFF
    return out.tobytes()


class FrameList:
    """an integer PCM sample container

    samples are stored internally as a signed int32 [frames, channels]
    NumPy array in interleaved (RIFF WAVE) channel order
    """

    __slots__ = ("samples", "bits_per_sample")

    def __init__(self, data, channels, bits_per_sample,
                 is_big_endian=False, is_signed=True):
        if isinstance(data, (bytes, bytearray, memoryview)):
            self.samples = _unpack_bytes(bytes(data), channels,
                                         bits_per_sample,
                                         is_big_endian, is_signed)
        else:
            arr = np.asarray(data, dtype=np.int32)
            if arr.ndim == 1:
                if channels < 1:
                    raise ValueError("channel count must be > 0")
                if len(arr) % channels:
                    raise ValueError(
                        "number of samples not divisible by channel count")
                arr = arr.reshape(-1, channels)
            elif arr.ndim != 2 or arr.shape[1] != channels:
                raise ValueError("bad sample array shape")
            self.samples = arr
        if bits_per_sample not in (8, 16, 24):
            raise ValueError("unsupported bits per sample")
        self.bits_per_sample = bits_per_sample

    # --- construction helpers -------------------------------------------
    @classmethod
    def _wrap(cls, samples, bits_per_sample):
        fl = cls.__new__(cls)
        fl.samples = samples
        fl.bits_per_sample = bits_per_sample
        return fl

    # --- attributes ------------------------------------------------------
    @property
    def frames(self):
        return self.samples.shape[0]

    @property
    def channels(self):
        return self.samples.shape[1]

    # --- sequence protocol ----------------------------------------------
    def __len__(self):
        return self.samples.size

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [int(v) for v in self.samples.reshape(-1)[i]]
        n = self.samples.size
        if i < 0:
            i += n
        if not (0 <= i < n):
            raise IndexError("index out of range")
        return int(self.samples.reshape(-1)[i])

    def __iter__(self):
        return iter(self.samples.reshape(-1).tolist())

    def __eq__(self, other):
        if isinstance(other, FrameList):
            return (self.bits_per_sample == other.bits_per_sample and
                    self.samples.shape == other.samples.shape and
                    bool(np.array_equal(self.samples, other.samples)))
        return NotImplemented

    def __ne__(self, other):
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    def __add__(self, other):
        if not isinstance(other, FrameList):
            raise TypeError("cannot concatenate FrameList with non-FrameList")
        if self.channels != other.channels:
            raise ValueError("both FrameLists must have the same channels")
        if self.bits_per_sample != other.bits_per_sample:
            raise ValueError(
                "both FrameLists must have the same bits_per_sample")
        return FrameList._wrap(
            np.concatenate([self.samples, other.samples], axis=0),
            self.bits_per_sample)

    def __mul__(self, count):
        return FrameList._wrap(np.tile(self.samples, (int(count), 1)),
                               self.bits_per_sample)

    def __repr__(self):
        return ("FrameList(frames=%d, channels=%d, bits_per_sample=%d)" %
                (self.frames, self.channels, self.bits_per_sample))

    # --- core API --------------------------------------------------------
    def frame(self, frame_number):
        """returns the given PCM frame as a 1-frame FrameList"""
        if not (0 <= frame_number < self.frames):
            raise IndexError("invalid frame number")
        return FrameList._wrap(self.samples[frame_number:frame_number + 1],
                               self.bits_per_sample)

    def channel(self, channel_number):
        """returns the given channel as a 1-channel FrameList"""
        if not (0 <= channel_number < self.channels):
            raise IndexError("invalid channel number")
        return FrameList._wrap(
            self.samples[:, channel_number:channel_number + 1],
            self.bits_per_sample)

    def split(self, frame_count):
        """returns a (head, tail) FrameList pair at the given frame count"""
        if frame_count < 0:
            raise IndexError("split point must be positive")
        return (FrameList._wrap(self.samples[:frame_count],
                                self.bits_per_sample),
                FrameList._wrap(self.samples[frame_count:],
                                self.bits_per_sample))

    def to_bytes(self, is_big_endian, is_signed):
        """returns the samples as a string of binary data"""
        return _pack_bytes(self.samples, self.bits_per_sample,
                           is_big_endian, is_signed)

    def to_float(self):
        """returns a FloatFrameList with the same data"""
        adjustment = 1 << (self.bits_per_sample - 1)
        return FloatFrameList._wrap(
            self.samples.astype(np.float64) / adjustment)

    def frame_count(self, byte_count):
        """given bytes, returns the max number of frames that fit (min 1)"""
        bytes_per_frame = self.channels * (self.bits_per_sample // 8)
        return max(byte_count // bytes_per_frame, 1)


class FloatFrameList:
    """a floating-point PCM sample container (float64 internally)"""

    __slots__ = ("samples",)

    def __init__(self, data, channels):
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim == 1:
            if channels < 1:
                raise ValueError("channel count must be > 0")
            if len(arr) % channels:
                raise ValueError(
                    "number of samples not divisible by channel count")
            arr = arr.reshape(-1, channels)
        elif arr.ndim != 2 or arr.shape[1] != channels:
            raise ValueError("bad sample array shape")
        self.samples = arr

    @classmethod
    def _wrap(cls, samples):
        fl = cls.__new__(cls)
        fl.samples = samples
        return fl

    @property
    def frames(self):
        return self.samples.shape[0]

    @property
    def channels(self):
        return self.samples.shape[1]

    def __len__(self):
        return self.samples.size

    def __getitem__(self, i):
        n = self.samples.size
        if i < 0:
            i += n
        if not (0 <= i < n):
            raise IndexError("index out of range")
        return float(self.samples.reshape(-1)[i])

    def __iter__(self):
        return iter(self.samples.reshape(-1).tolist())

    def __eq__(self, other):
        if isinstance(other, FloatFrameList):
            return (self.samples.shape == other.samples.shape and
                    bool(np.array_equal(self.samples, other.samples)))
        return NotImplemented

    def __add__(self, other):
        if not isinstance(other, FloatFrameList):
            raise TypeError("cannot concatenate FloatFrameList "
                            "with non-FloatFrameList")
        if self.channels != other.channels:
            raise ValueError("both FrameLists must have the same channels")
        return FloatFrameList._wrap(
            np.concatenate([self.samples, other.samples], axis=0))

    def __mul__(self, count):
        return FloatFrameList._wrap(np.tile(self.samples, (int(count), 1)))

    def __repr__(self):
        return ("FloatFrameList(frames=%d, channels=%d)" %
                (self.frames, self.channels))

    def frame(self, frame_number):
        if not (0 <= frame_number < self.frames):
            raise IndexError("invalid frame number")
        return FloatFrameList._wrap(
            self.samples[frame_number:frame_number + 1])

    def channel(self, channel_number):
        if not (0 <= channel_number < self.channels):
            raise IndexError("invalid channel number")
        return FloatFrameList._wrap(
            self.samples[:, channel_number:channel_number + 1])

    def split(self, frame_count):
        if frame_count < 0:
            raise IndexError("split point must be positive")
        return (FloatFrameList._wrap(self.samples[:frame_count]),
                FloatFrameList._wrap(self.samples[frame_count:]))

    def to_int(self, bits_per_sample):
        """returns a FrameList of ints at the given bits-per-sample

        conversion truncates toward zero and clamps to the sample range,
        matching reference src/pcm.c:1218-1224
        """
        adjustment = 1 << (bits_per_sample - 1)
        scaled = np.trunc(self.samples * adjustment)
        clipped = np.clip(scaled, -adjustment, adjustment - 1)
        return FrameList._wrap(clipped.astype(np.int32), bits_per_sample)


def from_list(list_of_ints, channels, bits_per_sample, is_signed):
    """builds a FrameList from a list of interleaved int samples"""
    arr = np.asarray(list(list_of_ints), dtype=np.int64)
    if not is_signed:
        arr = arr - (1 << (bits_per_sample - 1))
    if channels < 1:
        raise ValueError("channel count must be > 0")
    if len(arr) % channels:
        raise ValueError("number of samples not divisible by channel count")
    return FrameList._wrap(arr.astype(np.int32).reshape(-1, channels),
                           bits_per_sample)


def from_frames(frames):
    """builds a FrameList from a list of 1-frame FrameLists"""
    frames = list(frames)
    if len(frames) == 0:
        raise ValueError("at least one FrameList is required")
    channels = frames[0].channels
    bps = frames[0].bits_per_sample
    for f in frames:
        if f.frames != 1:
            raise ValueError("all subframes must be 1 frame long")
        if f.channels != channels or f.bits_per_sample != bps:
            raise ValueError("all subframes must have the same "
                             "channels and bits_per_sample")
    return FrameList._wrap(
        np.concatenate([f.samples for f in frames], axis=0), bps)


def from_channels(channels):
    """builds a FrameList from a list of 1-channel FrameLists"""
    channels = list(channels)
    if len(channels) == 0:
        raise ValueError("at least one FrameList is required")
    frames = channels[0].frames
    bps = channels[0].bits_per_sample
    for c in channels:
        if c.channels != 1:
            raise ValueError("all channels must be 1 channel wide")
        if c.frames != frames or c.bits_per_sample != bps:
            raise ValueError("all channels must have the same "
                             "length and bits_per_sample")
    return FrameList._wrap(
        np.concatenate([c.samples for c in channels], axis=1), bps)


def from_float_frames(frames):
    """builds a FloatFrameList from a list of 1-frame FloatFrameLists"""
    frames = list(frames)
    if len(frames) == 0:
        raise ValueError("at least one FloatFrameList is required")
    channels = frames[0].channels
    for f in frames:
        if f.frames != 1:
            raise ValueError("all subframes must be 1 frame long")
        if f.channels != channels:
            raise ValueError("all subframes must have the same channels")
    return FloatFrameList._wrap(
        np.concatenate([f.samples for f in frames], axis=0))


def from_float_channels(channels):
    """builds a FloatFrameList from a list of 1-channel FloatFrameLists"""
    channels = list(channels)
    if len(channels) == 0:
        raise ValueError("at least one FloatFrameList is required")
    frames = channels[0].frames
    for c in channels:
        if c.channels != 1:
            raise ValueError("all channels must be 1 channel wide")
        if c.frames != frames:
            raise ValueError("all channels must have the same length")
    return FloatFrameList._wrap(
        np.concatenate([c.samples for c in channels], axis=1))


def empty_framelist(channels, bits_per_sample):
    """returns an empty FrameList with the given attributes"""
    return FrameList._wrap(np.zeros((0, channels), dtype=np.int32),
                           bits_per_sample)
