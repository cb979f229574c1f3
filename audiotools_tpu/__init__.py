"""audiotools_tpu: an accelerator-native audio codec framework.

A from-scratch rebuild of the capabilities of Python Audio Tools
(reference at /root/reference) for JAX/XLA/Pallas: lossless codec
encode/decode, PCM stream processing, metadata editing, ReplayGain,
and verification, with batched device kernels replacing the reference's
sample-serial C extensions.

Public API parity with the reference package ``audiotools``:
``open()``, ``file_type()``, the PCMReader stream algebra, ``AudioFile``
subclasses per format, ``MetaData``, and the CLI tools under
``audiotools_tpu.cli``.
"""

VERSION = "0.1.0"

from .pcmstream import (  # noqa: F401,E402
    FRAMELIST_SIZE,
    BUFFER_SIZE,
    ChannelMask,
    PCMReader,
    PCMReaderError,
    PCMReaderProgress,
    ReorderedPCMReader,
    RemaskedPCMReader,
    PCMCat,
    BufferedPCMReader,
    CounterPCMReader,
    LimitedFileReader,
    LimitedPCMReader,
    PCMReaderWindow,
    PCMReaderHead,
    PCMReaderDeHead,
    PCMConverter,
    pcm_cmp,
    pcm_frame_cmp,
    pcm_split,
    to_pcm_progress,
    transfer_data,
    transfer_framelist_data,
    threaded_transfer_framelist_data,
    resampled_frame_count,
)

from . import pcm  # noqa: F401,E402


class UnsupportedFile(Exception):
    """raised by open() if the file cannot be identified or opened"""


class InvalidFile(Exception):
    """raised during initialization if the file is invalid"""


class EncodingError(IOError):
    """raised if an audio file cannot be created from a PCMReader"""

    def __init__(self, error_message):
        IOError.__init__(self, error_message)
        self.error_message = error_message


class UnsupportedBitsPerSample(EncodingError):
    """raised if an audio file cannot be created at the given bps"""

    def __init__(self, filename, bits_per_sample):
        EncodingError.__init__(
            self,
            "unsupported bits per sample: %d" % (bits_per_sample,))
        self.bits_per_sample = bits_per_sample


class UnsupportedChannelCount(EncodingError):
    """raised if an audio file cannot be created at the channel count"""

    def __init__(self, filename, channel_count):
        EncodingError.__init__(
            self,
            "unsupported channel count: %d" % (channel_count,))
        self.channel_count = channel_count


class UnsupportedChannelMask(EncodingError):
    """raised if an audio file cannot be created at the channel mask"""

    def __init__(self, filename, mask):
        EncodingError.__init__(
            self,
            "unsupported channel mask: %d" % (int(mask),))
        self.mask = mask


class DecodingError(IOError):
    """raised if a decoder's to_pcm() method fails"""

    def __init__(self, error_message):
        IOError.__init__(self, error_message)
        self.error_message = error_message


def __yes_no__(s):
    return s.strip().lower() in ("1", "true", "yes", "on")


# late imports so format modules can import the names above
from .audiofile import (  # noqa: F401,E402
    AudioFile,
    WaveContainer,
    AiffContainer,
    MetaData,
    AlbumMetaData,
    Image,
    ReplayGain,
    Sheet,
    SheetTrack,
    SheetIndex,
)
from .dispatch import (  # noqa: F401,E402
    open,
    open_files,
    open_directory,
    file_type,
    sorted_tracks,
    group_tracks,
    AVAILABLE_TYPES,
    TYPE_MAP,
    DEFAULT_TYPE,
    Filename,
)
from .utils.files import TemporaryFile, make_dirs  # noqa: F401,E402
from .utils.config import MAX_JOBS  # noqa: F401,E402
from .cdio import CDDA, CDTrackReader  # noqa: F401,E402
from .parallel.queue import (  # noqa: F401,E402
    ExecProgressQueue,
    ExecQueueError,
)
from .services.lookup import (  # noqa: F401,E402
    metadata_lookup,
    track_metadata_lookup,
    accuraterip_lookup,
)


def calculate_replay_gain(tracks, progress=None):
    """yields (track, gain, peak, album_gain, album_peak) per track
    (reference __init__.py:2845)"""
    from .replaygain import calculate_replay_gain_values
    return calculate_replay_gain_values(tracks, progress)


# ---- reference package-root API parity --------------------------------------
# names the reference exports from ``audiotools`` directly
# (reference __init__.py); kept importable from the package root so a
# reference user finds them where they expect
from .audiofile import (  # noqa: F401,E402
    DummyAudioFile,
    InvalidFilenameFormat,
    UnsupportedTracknameField,
    build_timestamp,
    parse_timestamp,
    read_sheet,
)
from .dispatch import (  # noqa: F401,E402
    DuplicateFile,
    DuplicateOutputFile,
    OutputFileIsInput,
    UnknownAudioType,
    AmbiguousAudioType,
    filename_to_type,
)
from .utils.messenger import (  # noqa: F401,E402
    Messenger,
    SilentMessenger,
    ProgressDisplay,
    SingleProgressDisplay,
    ReplayGainProgressDisplay,
    ProgressRow,
    DummyOutput,
    output_table,
    output_table_row,
    output_table_blank,
    output_table_divider,
    output_text,
    output_list,
    output_progress,
)
from .utils.helpers import (  # noqa: F401,E402
    get_umask,
    khz,
    at_a_time,
    iter_first,
    iter_last,
    most_numerous,
    ignore_sigint,
)
from .pcmstream import stripped_pcm_cmp  # noqa: F401,E402
from .sheets.cue import SheetException  # noqa: F401,E402
from .meta.image import InvalidImage  # noqa: F401,E402
from .cdio import CDTrackLog  # noqa: F401,E402
from .services.lookup import accuraterip_sheet_lookup  # noqa: F401,E402
from .replaygain import applicable_replay_gain  # noqa: F401,E402

# the reference re-exports these stdlib names for its tools; kept as
# thin aliases (the tools here use argparse natively)
from optparse import (  # noqa: F401,E402
    OptionParser,
    OptionGroup,
)
from configparser import RawConfigParser  # noqa: F401,E402
