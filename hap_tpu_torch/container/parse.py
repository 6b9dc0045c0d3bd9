"""Host-side frame parsing: Hap bytes -> per-texture chunk tables.

A copy of the reference package's parser for any legal frame: the
section-header walk (4- and 8-byte headers, multi-image frames), the
decode-instruction tables of a Complex section in any section order
(unknown sections skipped, an optional chunk offset table, so chunks may be
stored in any order), and the whole-section Snappy and None compressors.
Validation follows the reference decoder: a section may not extend past its
buffer, the instruction tables must agree on the chunk count, and unknown
texture formats, unknown chunk compressors and chunks past the buffer are
Bad_Frame.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from hap_tpu_torch.constants import (
    CHUNK_COMPRESSOR_NONE,
    CHUNK_COMPRESSOR_SNAPPY,
    COMPRESSOR_COMPLEX,
    COMPRESSOR_NONE,
    COMPRESSOR_SNAPPY,
    FORMAT_NAMES,
    SECTION_CHUNK_COMPRESSOR_TABLE,
    SECTION_CHUNK_OFFSET_TABLE,
    SECTION_CHUNK_SIZE_TABLE,
    SECTION_DECODE_INSTRUCTIONS,
    SECTION_MULTIPLE_IMAGES,
    HapError,
)
from hap_tpu_torch.snappy.pyref import read_varint


@dataclasses.dataclass
class TexturePlan:
    """Chunk tables of one texture section; offsets are absolute into the
    frame, uncompressed offsets into the decoded texture."""

    format_id: int         # stored format nibble
    stored_compressor: int  # 0xA / 0xB / 0xC
    chunk_count: int
    chunk_compressors: np.ndarray         # uint8 (N,)
    chunk_compressed_offsets: np.ndarray  # int64 (N,)
    chunk_compressed_sizes: np.ndarray    # int64 (N,)
    chunk_uncompressed_offsets: np.ndarray  # int64 (N,)
    chunk_uncompressed_sizes: np.ndarray    # int64 (N,)
    decoded_bytes: int


@dataclasses.dataclass
class FramePlan:
    textures: List[TexturePlan]
    is_multi_image: bool


def read_section_header(buf, offset: int = 0):
    """(header_length, section_length, section_type) of the header at
    ``offset``; the section must fit in ``buf``."""
    view = memoryview(buf)
    avail = len(view) - offset
    if avail < 4:
        raise HapError("buffer too small for a section header")
    b = view[offset: offset + 4]
    length = b[0] | (b[1] << 8) | (b[2] << 16)
    header_length = 4
    if length == 0:
        if avail < 8:
            raise HapError("buffer too small for an 8-byte header")
        length = int.from_bytes(view[offset + 4: offset + 8], "little")
        header_length = 8
    if header_length + length > avail:
        raise HapError("section extends beyond the buffer")
    return header_length, length, b[3]


def _locate_sections(data):
    """(is_multi, [(body_offset, length, type), ...]) of the top level."""
    hdr, length, stype = read_section_header(data, 0)
    if stype != SECTION_MULTIPLE_IMAGES:
        return False, [(hdr, length, stype)]
    sections, offset, end = [], hdr, hdr + length
    while offset < end:
        chdr, clen, ctype = read_section_header(data, offset)
        sections.append((offset + chdr, clen, ctype))
        offset += chdr + clen
    return True, sections


def _parse_decode_instructions(data, body_offset: int, body_length: int):
    """Walk a Complex section's Decode Instructions Container ->
    (chunk_count, compressors, sizes, offsets or None, frame data offset)."""
    view = memoryview(data)
    dic_hdr, dic_len, dic_type = read_section_header(
        view[body_offset: body_offset + body_length], 0)
    if dic_type != SECTION_DECODE_INSTRUCTIONS:
        raise HapError("expected the Decode Instructions Container")
    chunk_count = 0
    compressors = sizes = offsets = None
    pos = body_offset + dic_hdr
    remaining = dic_len
    while remaining > 0:
        hdr, length, stype = read_section_header(view[pos: pos + remaining], 0)
        body = np.frombuffer(view[pos + hdr: pos + hdr + length], np.uint8)
        n = 0
        if stype == SECTION_CHUNK_COMPRESSOR_TABLE:
            compressors, n = body, length
        elif stype == SECTION_CHUNK_SIZE_TABLE:
            sizes = body[: length // 4 * 4].view("<u4").astype(np.int64)
            n = length // 4
        elif stype == SECTION_CHUNK_OFFSET_TABLE:
            offsets = body[: length // 4 * 4].view("<u4").astype(np.int64)
            n = length // 4
        if n:
            if chunk_count and n != chunk_count:
                raise HapError("chunk tables disagree on the chunk count")
            chunk_count = n
        pos += hdr + length
        remaining -= hdr + length
    if compressors is None or sizes is None:
        raise HapError("missing chunk compressor or size table")
    return (chunk_count, compressors, sizes, offsets,
            body_offset + dic_hdr + dic_len)


def _plan_texture(data, body_offset: int, body_length: int,
                  section_type: int) -> TexturePlan:
    compressor = section_type >> 4
    fmt = section_type & 0xF
    if fmt not in FORMAT_NAMES:
        raise HapError(f"unknown texture format id {fmt:#x}")
    view = memoryview(data)
    if compressor == COMPRESSOR_COMPLEX:
        n, comps, sizes, offs, data_off = _parse_decode_instructions(
            data, body_offset, body_length)
        if n == 0:
            z = np.zeros(0, np.int64)
            return TexturePlan(fmt, compressor, 0, np.zeros(0, np.uint8),
                               z, z, z, z, 0)
        comps = np.ascontiguousarray(comps[:n])
        sizes = np.ascontiguousarray(sizes[:n])
        bad = (comps != CHUNK_COMPRESSOR_SNAPPY) & (comps != CHUNK_COMPRESSOR_NONE)
        if bad.any():
            raise HapError(f"unknown chunk compressor {comps[bad][0]:#x}")
        if offs is not None:
            starts = data_off + np.ascontiguousarray(offs[:n])
        else:
            starts = data_off + np.concatenate(([0], np.cumsum(sizes[:-1])))
        un_sizes = np.empty(n, np.int64)
        for i in range(n):
            a, b = int(starts[i]), int(starts[i]) + int(sizes[i])
            if a < 0 or b > len(view):
                raise HapError("chunk extends beyond the buffer")
            un_sizes[i] = (read_varint(view[a:b], 0)[0]
                           if comps[i] == CHUNK_COMPRESSOR_SNAPPY else sizes[i])
        un_offsets = np.concatenate(([0], np.cumsum(un_sizes[:-1])))
        return TexturePlan(fmt, compressor, n, comps, starts.astype(np.int64),
                           sizes, un_offsets.astype(np.int64), un_sizes,
                           int(un_sizes.sum()))
    if compressor in (COMPRESSOR_SNAPPY, COMPRESSOR_NONE):
        if compressor == COMPRESSOR_SNAPPY:
            decoded = read_varint(view[body_offset: body_offset + body_length])[0]
            comp = CHUNK_COMPRESSOR_SNAPPY
        else:
            decoded, comp = body_length, CHUNK_COMPRESSOR_NONE
        one = lambda v: np.array([v], np.int64)  # noqa: E731
        return TexturePlan(fmt, compressor, 1, np.array([comp], np.uint8),
                           one(body_offset), one(body_length), one(0),
                           one(decoded), decoded)
    raise HapError(f"unknown compressor nibble {compressor:#x}")


def parse_frame(data) -> FramePlan:
    """Parse a whole Hap frame into a FramePlan (all textures)."""
    is_multi, sections = _locate_sections(data)
    return FramePlan([_plan_texture(data, *s) for s in sections], is_multi)
