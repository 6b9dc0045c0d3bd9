"""Hap wire-format constants used by the Hap Q main path.

Copied from the reference package's constants and chunk planner (the port
keeps its own copy). The stored top-level section type byte packs
(compressor nibble << 4) | format nibble.
"""

from __future__ import annotations

COMPRESSOR_NONE = 0xA
COMPRESSOR_SNAPPY = 0xB
COMPRESSOR_COMPLEX = 0xC

FORMAT_YCOCG_DXT5 = 0xF  # Hap Q's stored format nibble

# Stored format nibble -> texture format name, for every format the
# container knows (only YCoCg_DXT5 is decoded by the port so far).
FORMAT_NAMES = {
    0xB: "RGB_DXT1",
    0xE: "RGBA_DXT5",
    0xF: "YCoCg_DXT5",
    0x1: "A_RGTC1",
    0xC: "RGBA_BPTC_UNORM",
    0x2: "RGB_BPTC_UNSIGNED_FLOAT",
    0x3: "RGB_BPTC_SIGNED_FLOAT",
}

SECTION_MULTIPLE_IMAGES = 0x0D
SECTION_DECODE_INSTRUCTIONS = 0x01
SECTION_CHUNK_COMPRESSOR_TABLE = 0x02
SECTION_CHUNK_SIZE_TABLE = 0x03
SECTION_CHUNK_OFFSET_TABLE = 0x04

CHUNK_COMPRESSOR_NONE = 0x0A
CHUNK_COMPRESSOR_SNAPPY = 0x0B

UINT24_MAX = 0x00FFFFFF
MAX_CHUNK_COUNT = 3355431

HAP_Q_BLOCK_BYTES = 16  # YCoCg-DXT5 (BC3 layout): BC4 Y + BC1 CoCg per block


def dxt_payload_bytes(width: int, height: int, block_bytes: int) -> int:
    """Bytes of the block-compressed payload of a W x H frame: whole 4x4
    blocks cover the (edge-padded) frame."""
    return ((width + 3) // 4) * ((height + 3) // 4) * block_bytes


def legalize_chunk_count(input_bytes: int, block_bytes: int,
                         chunk_count: int) -> int:
    """The reference encoder's chunk-count rule: cap at MAX_CHUNK_COUNT, then
    step down until the block count divides evenly. The stored frame
    records the outcome, so it is part of the wire contract."""
    chunk_count = min(chunk_count, MAX_CHUNK_COUNT)
    block_count = input_bytes // block_bytes
    while block_count % chunk_count != 0:
        chunk_count -= 1
    return chunk_count


class HapError(ValueError):
    """A malformed frame or stream (the reference's Bad_Frame result)."""
