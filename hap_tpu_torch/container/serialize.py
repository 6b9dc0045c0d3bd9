"""Host-side Hap frame writer for Hap Q: codec output bytes -> frame bytes.

A copy of the reference package's host serializer, kept to one Hap Q
texture. It lays frames out as the reference encoder ``hap.c`` does:
header length chosen from the uncompressed worst case and re-checked with
the decode-instructions overhead, per-chunk raw fallback when Snappy does
not shrink a chunk, whole-frame fallback to uncompressed storage when the
chunked frame is not smaller, and no chunk offset table.

Chunks are compressed with the port's pure-Python Snappy unless their
streams are given (``precompressed``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from hap_tpu_torch.constants import (
    CHUNK_COMPRESSOR_NONE,
    CHUNK_COMPRESSOR_SNAPPY,
    COMPRESSOR_COMPLEX,
    COMPRESSOR_NONE,
    FORMAT_YCOCG_DXT5,
    HAP_Q_BLOCK_BYTES,
    SECTION_CHUNK_COMPRESSOR_TABLE,
    SECTION_CHUNK_SIZE_TABLE,
    SECTION_DECODE_INSTRUCTIONS,
    UINT24_MAX,
    HapError,
    legalize_chunk_count,
)
from hap_tpu_torch.snappy import pyref


def write_section_header(header_length: int, section_length: int,
                         section_type: int) -> bytes:
    """A 4- or 8-byte section header."""
    if header_length == 4:
        if section_length > UINT24_MAX:
            raise HapError("section too long for a 4-byte header")
        return (section_length.to_bytes(3, "little")
                + bytes([section_type & 0xFF]))
    if header_length != 8:
        raise HapError(f"bad header length {header_length}")
    return (bytes([0, 0, 0, section_type & 0xFF])
            + section_length.to_bytes(4, "little"))


def decode_instructions_length(chunk_count: int) -> int:
    """Body length of a Decode Instructions Container for N chunks: the
    compressor table, the size table and their two 4-byte headers."""
    return 5 * chunk_count + 8


def serialize_texture(data, snappy: bool = True, chunk_count: int = 1,
                      precompressed: Optional[Sequence[bytes]] = None
                      ) -> bytes:
    """One Hap Q texture's block data -> a top-level section (a whole
    single-texture frame).

    With ``snappy`` the chunk count is legalized as the reference encoder
    does; ``precompressed``, if given, must then hold one stream per legal
    chunk. Without ``snappy`` the data is stored uncompressed."""
    view = memoryview(data)
    input_bytes = len(view)
    if input_bytes == 0:
        raise HapError("empty texture data")
    if chunk_count == 0:
        raise HapError("chunk count must be >= 1")
    top_header_length = 8 if input_bytes > UINT24_MAX else 4

    if snappy:
        chunk_count = legalize_chunk_count(input_bytes, HAP_Q_BLOCK_BYTES,
                                           chunk_count)
        dil = decode_instructions_length(chunk_count)
        if input_bytes + dil + 4 > UINT24_MAX:
            top_header_length = 8
        chunk_size = input_bytes // chunk_count
        if precompressed is not None:
            if len(precompressed) != chunk_count:
                raise HapError(f"precompressed chunk count "
                               f"{len(precompressed)} != legalized "
                               f"{chunk_count}")
            packed = list(precompressed)
        else:
            packed = [pyref.compress(view[i * chunk_size:
                                          (i + 1) * chunk_size])
                      for i in range(chunk_count)]
        chunk_comp = bytearray(chunk_count)
        chunk_sizes = bytearray()
        payload = bytearray()
        for i, blob in enumerate(packed):
            if len(blob) >= chunk_size:  # raw fallback: no saving
                blob = bytes(view[i * chunk_size: (i + 1) * chunk_size])
                chunk_comp[i] = CHUNK_COMPRESSOR_NONE
            else:
                chunk_comp[i] = CHUNK_COMPRESSOR_SNAPPY
            chunk_sizes += len(blob).to_bytes(4, "little")
            payload += blob
        top_section_length = 4 + dil + len(payload)
        if top_section_length < input_bytes + top_header_length:
            return b"".join((
                write_section_header(top_header_length, top_section_length,
                                     (COMPRESSOR_COMPLEX << 4)
                                     | FORMAT_YCOCG_DXT5),
                write_section_header(4, dil, SECTION_DECODE_INSTRUCTIONS),
                write_section_header(4, chunk_count,
                                     SECTION_CHUNK_COMPRESSOR_TABLE),
                bytes(chunk_comp),
                write_section_header(4, 4 * chunk_count,
                                     SECTION_CHUNK_SIZE_TABLE),
                bytes(chunk_sizes),
                bytes(payload),
            ))
        # else: uncompressed storage, as the reference encoder falls back

    return write_section_header(
        top_header_length, input_bytes,
        (COMPRESSOR_NONE << 4) | FORMAT_YCOCG_DXT5) + bytes(view)


def serialize_frame(textures: Sequence, snappy: bool = True,
                    chunk_count: int = 1,
                    precompressed: Optional[Sequence[bytes]] = None
                    ) -> bytes:
    """A Hap Q frame: one texture, a bare top-level section. Frames of two
    textures (Hap Q Alpha) are not ported yet."""
    if len(textures) != 1:
        raise NotImplementedError(
            "only single-texture (Hap Q) frames are ported")
    return serialize_texture(textures[0], snappy, chunk_count, precompressed)
