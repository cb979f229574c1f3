"""Shared final-batch shape grid for the device-analysis encoders.

Both packed encoders (FLAC and ALAC) pad a final partial batch of B
blocks up to a small STATIC grid of shapes ({batch//8, batch//4,
batch//2, batch}) before upload.  Fixed shapes matter more than the
wasted rows: a final batch of B < batch_frames blocks would otherwise
compile a fresh XLA program per distinct track length.  Padding straight
to the full batch is wasteful the other way: a transcode farm of ~20 s
tracks (215 blocks) would upload and analyze 512-block batches, 2.4x
the wire bytes and device compute per track.  The power-of-two grid bounds the compile count at 4
shapes per wire width while capping pad waste below 2x.

ATPU_PAD_GRID=0 disables the grid (restores full-batch padding) for
every codec; the older FLAC-named ATPU_FLAC_PAD_GRID is honored as an
alias for compatibility.
"""

import os


def enabled():
    """is the shape grid on? (default yes; covers FLAC and ALAC)"""
    value = os.environ.get("ATPU_PAD_GRID")
    if value is None:
        value = os.environ.get("ATPU_FLAC_PAD_GRID", "1")
    return value != "0"


def target_rows(B, batch_frames):
    """rows to pad a B-row final batch to: the smallest grid shape in
    {batch//8, batch//4, batch//2, batch} holding B rows (the full
    batch when the grid is disabled)"""
    target = batch_frames
    if enabled():
        floor = max(batch_frames // 8, 1)
        while target // 2 >= max(B, floor) and target % 2 == 0:
            target //= 2
    return target
