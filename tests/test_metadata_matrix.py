"""Metadata conversion-matrix tests.

The reference validates tag handling with a conversion matrix between
every tagging format (/root/reference/test/test_metadata.py): each
format's ``converted()`` classmethod must preserve every field the
format can represent, pairwise conversions must preserve the
intersection of both formats' fields, and serialization must
round-trip.  This suite re-derives that strategy for this build's
tag classes.
"""

import io

import pytest

from audiotools_tpu import MetaData, Image
from audiotools_tpu.bitstream import BitstreamReader, BitstreamWriter
from audiotools_tpu.meta.ape import ApeTag
from audiotools_tpu.meta.id3 import (ID3v22Comment, ID3v23Comment,
                                     ID3v24Comment, ID3CommentPair)
from audiotools_tpu.meta.id3v1 import ID3v1Comment
from audiotools_tpu.meta.vorbiscomment import VorbisComment
from audiotools_tpu.formats.flac import Flac_VORBISCOMMENT

PNG = bytes.fromhex(
    "89504e470d0a1a0a0000000d49484452000000010000000108020000009077"
    "53de0000000c4944415408d763f8cfc000000301010018dd8db00000000049"
    "454e44ae426082")


def full_metadata():
    return MetaData(track_name=u"Tést Track ♫",
                    track_number=3,
                    track_total=12,
                    album_name=u"Album Å",
                    artist_name=u"Artist Ж",
                    performer_name=u"Performer",
                    composer_name=u"Composer",
                    conductor_name=u"Conductor",
                    media=u"CD",
                    ISRC=u"US-PR3-08-12345",
                    catalog=u"CAT-001",
                    copyright=u"2008 Tester",
                    publisher=u"Test Records",
                    year=u"2008",
                    date=u"2008-02-28",
                    album_number=2,
                    album_total=4,
                    comment=u"A comment line")


TAG_CLASSES = [ID3v22Comment, ID3v23Comment, ID3v24Comment,
               ID3v1Comment, ApeTag, VorbisComment,
               Flac_VORBISCOMMENT]


def supported_fields(cls):
    """the fields cls.converted() preserves (derived, then asserted
    stable below)"""
    m = full_metadata()
    tag = cls.converted(m)
    return frozenset(f for f in MetaData.FIELDS
                     if getattr(tag, f) == getattr(m, f))


# conversion floors: every format must preserve at least these
MINIMUM_FIELDS = {
    ID3v22Comment: {"track_name", "track_number", "track_total",
                    "album_name", "artist_name", "year", "comment"},
    ID3v23Comment: {"track_name", "track_number", "track_total",
                    "album_name", "artist_name", "year", "comment"},
    ID3v24Comment: {"track_name", "track_number", "track_total",
                    "album_name", "artist_name", "year", "comment"},
    ID3v1Comment: {"track_name", "album_name", "artist_name",
                   "year"},
    ApeTag: {"track_name", "track_number", "track_total",
             "album_name", "artist_name", "performer_name",
             "composer_name", "conductor_name", "ISRC", "catalog",
             "copyright", "publisher", "year", "date", "comment"},
    # the reference's VorbisComment maps year->DATE and carries no
    # separate recording-date key (reference vorbiscomment.py:39)
    VorbisComment: set(MetaData.FIELDS) - {"date"},
    Flac_VORBISCOMMENT: set(MetaData.FIELDS) - {"date"},
}


@pytest.mark.parametrize("cls", TAG_CLASSES,
                         ids=lambda c: c.__name__)
def test_converted_preserves_minimum_fields(cls):
    assert supported_fields(cls) >= MINIMUM_FIELDS[cls]


@pytest.mark.parametrize("cls", TAG_CLASSES,
                         ids=lambda c: c.__name__)
def test_converted_identity(cls):
    """converting a format's own instance returns an equivalent tag"""
    tag = cls.converted(full_metadata())
    again = cls.converted(tag)
    for f in supported_fields(cls):
        assert getattr(again, f) == getattr(tag, f), f


@pytest.mark.parametrize("src", TAG_CLASSES, ids=lambda c: c.__name__)
@pytest.mark.parametrize("dst", TAG_CLASSES, ids=lambda c: c.__name__)
def test_pairwise_conversion_preserves_intersection(src, dst):
    """src -> dst keeps every field both formats support"""
    m = full_metadata()
    via = dst.converted(src.converted(m))
    keep = supported_fields(src) & supported_fields(dst)
    for f in keep:
        assert getattr(via, f) == getattr(m, f), (src, dst, f)


@pytest.mark.parametrize("cls", [ID3v22Comment, ID3v23Comment,
                                 ID3v24Comment],
                         ids=lambda c: c.__name__)
def test_id3v2_build_parse_roundtrip(cls):
    tag = cls.converted(full_metadata())
    buf = io.BytesIO()
    w = BitstreamWriter(buf, False)
    tag.build(w)
    w.flush()
    buf.seek(0)
    parsed = cls.parse(BitstreamReader(buf, False))
    for f in supported_fields(cls):
        assert getattr(parsed, f) == getattr(tag, f), f


def test_id3v1_build_parse_roundtrip():
    # ID3v1 is latin-1 on disk: use an ascii corpus for byte fidelity
    m = full_metadata()
    m.track_name = u"Plain Track"
    m.artist_name = u"Plain Artist"
    m.album_name = u"Plain Album"
    m.comment = u"plain comment"
    tag = ID3v1Comment.converted(m)
    buf = io.BytesIO()
    tag.build(buf)
    data = buf.getvalue()
    assert len(data) == 128 and data[:3] == b"TAG"
    buf.seek(0)
    parsed = ID3v1Comment.parse(buf)
    for f in supported_fields(ID3v1Comment):
        assert getattr(parsed, f) == getattr(tag, f), f


def test_apetag_build_read_roundtrip():
    tag = ApeTag.converted(full_metadata())
    data = tag.build()
    parsed = ApeTag.read(io.BytesIO(data))
    assert parsed is not None
    for f in supported_fields(ApeTag):
        assert getattr(parsed, f) == getattr(tag, f), f


@pytest.mark.parametrize("cls", [ID3v22Comment, ID3v23Comment,
                                 ID3v24Comment, ApeTag],
                         ids=lambda c: c.__name__)
def test_images_survive_serialization(cls):
    if not cls.supports_images():
        pytest.skip("format stores no images")
    tag = cls.converted(full_metadata())
    img = Image.new(PNG, u"front cover", 0)
    tag.add_image(img)
    if cls is ApeTag:
        parsed = ApeTag.read(io.BytesIO(tag.build()))
    else:
        buf = io.BytesIO()
        w = BitstreamWriter(buf, False)
        tag.build(w)
        w.flush()
        buf.seek(0)
        parsed = cls.parse(BitstreamReader(buf, False))
    imgs = parsed.images()
    assert len(imgs) == 1
    assert imgs[0].data == PNG
    assert imgs[0].mime_type == u"image/png"
    assert (imgs[0].width, imgs[0].height) == (1, 1)


@pytest.mark.parametrize("src,dst", [(ID3v24Comment, ApeTag),
                                     (ApeTag, ID3v24Comment),
                                     (ID3v24Comment, VorbisComment)],
                         ids=str)
def test_images_survive_conversion(src, dst):
    tag = src.converted(full_metadata())
    if not src.supports_images():
        pytest.skip("source stores no images")
    tag.add_image(Image.new(PNG, u"front cover", 0))
    converted = dst.converted(tag)
    if dst.supports_images():
        assert [i.data for i in converted.images()] == [PNG]
    # metadata fields still intact either way
    keep = supported_fields(src) & supported_fields(dst)
    m = full_metadata()
    for f in keep:
        assert getattr(converted, f) == getattr(m, f), f


def test_id3_comment_pair_prefers_v2():
    pair = ID3CommentPair.converted(full_metadata())
    assert pair.track_name == full_metadata().track_name
    assert pair.track_number == 3
    # the v1 half carries the truncatable subset
    assert pair.id3v1.track_name == full_metadata().track_name[:30]


def test_field_deletion_roundtrip():
    """delattr removes a field from every format that stores it"""
    for cls in TAG_CLASSES:
        tag = cls.converted(full_metadata())
        if "comment" not in supported_fields(cls):
            continue
        delattr(tag, "comment")
        assert tag.comment is None, cls


def test_unicode_preserved_through_id3v22_latin_fallback():
    """non-latin text survives every ID3v2 version's encoding choice"""
    m = full_metadata()
    for cls in (ID3v22Comment, ID3v23Comment, ID3v24Comment):
        tag = cls.converted(m)
        buf = io.BytesIO()
        w = BitstreamWriter(buf, False)
        tag.build(w)
        w.flush()
        buf.seek(0)
        parsed = cls.parse(BitstreamReader(buf, False))
        assert parsed.track_name == m.track_name
        assert parsed.artist_name == m.artist_name
