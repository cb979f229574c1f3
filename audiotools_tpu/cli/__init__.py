"""CLI tools: the track2track / trackinfo / ... utility family.

Rebuild of the reference's 21 executable scripts (repo root of
``/root/reference``): each tool is a module with a ``main(args)``
entry point, installed via thin wrappers in the repo's ``tools/``
directory.
"""

from __future__ import annotations

import os

# restore default SIGPIPE handling so tools piped into head/grep
# exit quietly instead of tracebacking on BrokenPipeError
try:
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
except (ImportError, AttributeError, ValueError):
    pass        # non-POSIX or non-main-thread import


def audiofile_type(messenger, type_name):
    """resolves a -t/--type argument to an AudioFile class"""
    from ..dispatch import TYPE_MAP
    from ..text import ERR_UNSUPPORTED_AUDIO_TYPE, ERR_SUPPORTED_TYPES
    if type_name in TYPE_MAP:
        return TYPE_MAP[type_name]
    else:
        messenger.error(ERR_UNSUPPORTED_AUDIO_TYPE %
                        {"type": type_name})
        messenger.info(ERR_SUPPORTED_TYPES %
                       {"types": ", ".join(sorted(TYPE_MAP.keys()))})
        return None


def default_type():
    from ..utils.config import DEFAULT_TYPE
    from ..dispatch import TYPE_MAP
    return DEFAULT_TYPE if DEFAULT_TYPE in TYPE_MAP else "wav"


def add_common_arguments(parser):
    from ..text import HELP_VERBOSITY, HELP_VERSION
    from .. import VERSION
    parser.add_argument("-V", "--verbose", dest="verbosity",
                        default="normal",
                        choices=("normal", "quiet", "silent", "debug"),
                        help=HELP_VERBOSITY)
    parser.add_argument("--version", action="version",
                        version="tpu-audio-tools %s"
                        % (VERSION,), help=HELP_VERSION)


def output_filename(track, destination_dir, output_format, suffix,
                    metadata):
    """builds an output path for a converted track"""
    from ..audiofile import AudioFile
    basename = AudioFile.track_name(track.filename, metadata,
                                    output_format, suffix=suffix)
    return os.path.join(destination_dir, basename)


def add_lookup_arguments(parser):
    """adds the metadata-lookup option family shared by
    track2track/trackcat/tracksplit/cd2track/dvda2track/tracktag
    (reference internal_lookup_options)"""
    from ..text import (HELP_METADATA_LOOKUP, HELP_USE_DEFAULT,
                        HELP_INTERACTIVE)
    parser.add_argument("-M", "--metadata-lookup",
                        action="store_true", default=False,
                        dest="metadata_lookup",
                        help=HELP_METADATA_LOOKUP)
    parser.add_argument("--musicbrainz-server",
                        dest="musicbrainz_server",
                        default="musicbrainz.org")
    parser.add_argument("--musicbrainz-port", type=int,
                        dest="musicbrainz_port", default=80)
    parser.add_argument("--no-musicbrainz", dest="use_musicbrainz",
                        action="store_false", default=True)
    parser.add_argument("--freedb-server", dest="freedb_server",
                        default="us.freedb.org")
    parser.add_argument("--freedb-port", type=int,
                        dest="freedb_port", default=80)
    parser.add_argument("--no-freedb", dest="use_freedb",
                        action="store_false", default=True)
    parser.add_argument("-D", "--default", dest="use_default",
                        action="store_true", default=False,
                        help=HELP_USE_DEFAULT)
