"""Pure-Python Snappy codec: an independent host-side check.

A copy of the reference package's strict decoder (any malformed stream
raises HapError) and of its greedy hash-matching compressor. The decoder
shares no code with the port's CUDA decode kernels and accepts every
conforming Snappy stream (copy-1/2/4, 1-5 byte literal headers), so it can
verify the port's streams byte for byte. The compressor writes
google-snappy-format streams (copy-1 elements, long literals, 64 KB
blocks), the kind of stream foreign encoders put in Hap frames.
"""

from __future__ import annotations

from hap_tpu_torch.constants import HapError

TAG_LITERAL, TAG_COPY1, TAG_COPY2, TAG_COPY4 = 0, 1, 2, 3
_BLOCK_SIZE = 65536  # matches never cross 64 KB input blocks
_MAX_HASH_BITS = 14


def read_varint(buf, offset: int = 0):
    """Little-endian base-128 varint -> (value, bytes read)."""
    view = memoryview(buf)
    result = shift = 0
    pos = offset
    while True:
        if pos >= len(view) or shift > 32:
            raise HapError("truncated or overlong snappy varint")
        b = view[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos - offset
        shift += 7


def decompress(data, expected_length: int | None = None) -> bytes:
    """Decode one Snappy stream. If ``expected_length`` is given, the
    preamble must match it."""
    view = memoryview(data)
    n = len(view)
    out_len, pos = read_varint(view, 0)
    if expected_length is not None and out_len != expected_length:
        raise HapError("snappy preamble length mismatch")
    out = bytearray(out_len)
    op = 0
    while pos < n:
        tag = view[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if pos + extra > n:
                    raise HapError("truncated literal length")
                length = int.from_bytes(view[pos: pos + extra], "little") + 1
                pos += extra
            if pos + length > n or op + length > out_len:
                raise HapError("literal overruns buffer")
            out[op: op + length] = view[pos: pos + length]
            pos += length
            op += length
            continue
        if kind == 1:  # copy-1
            if pos + 1 > n:
                raise HapError("truncated copy-1")
            length = ((tag >> 2) & 7) + 4
            offset = ((tag >> 5) << 8) | view[pos]
            pos += 1
        else:  # copy-2 / copy-4
            w = 2 if kind == 2 else 4
            if pos + w > n:
                raise HapError("truncated copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(view[pos: pos + w], "little")
            pos += w
        if offset == 0 or offset > op or op + length > out_len:
            raise HapError("bad copy offset or length")
        # an overlapping copy repeats the last `offset` bytes
        period = out[op - offset: op]
        out[op: op + length] = (period * (length // offset + 1))[:length]
        op += length
    if op != out_len:
        raise HapError("snappy stream ended short")
    return bytes(out)


def write_varint(value: int) -> bytes:
    """Little-endian base-128 varint of ``value``."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _hash(u32: int, shift: int) -> int:
    return ((u32 * 0x1E35A7BD) & 0xFFFFFFFF) >> shift


def _emit_literal(out: bytearray, data: memoryview, start: int,
                  length: int) -> None:
    n = length - 1
    if n < 60:
        out.append((n << 2) | TAG_LITERAL)
    elif n < (1 << 8):
        out.append((60 << 2) | TAG_LITERAL)
        out.append(n)
    elif n < (1 << 16):
        out.append((61 << 2) | TAG_LITERAL)
        out += n.to_bytes(2, "little")
    elif n < (1 << 24):
        out.append((62 << 2) | TAG_LITERAL)
        out += n.to_bytes(3, "little")
    else:
        out.append((63 << 2) | TAG_LITERAL)
        out += n.to_bytes(4, "little")
    out += data[start: start + length]


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    # Long copies are split into <= 64-byte elements; a copy-1 element is
    # used when possible (4 <= len <= 11, offset < 2048).
    while length >= 68:
        _emit_copy_upto64(out, offset, 64)
        length -= 64
    if length > 64:
        _emit_copy_upto64(out, offset, 60)
        length -= 60
    _emit_copy_upto64(out, offset, length)


def _emit_copy_upto64(out: bytearray, offset: int, length: int) -> None:
    if 4 <= length < 12 and offset < 2048:
        out.append(TAG_COPY1 | ((length - 4) << 2) | ((offset >> 8) << 5))
        out.append(offset & 0xFF)
    elif offset < 65536:
        out.append(TAG_COPY2 | ((length - 1) << 2))
        out += offset.to_bytes(2, "little")
    else:
        out.append(TAG_COPY4 | ((length - 1) << 2))
        out += offset.to_bytes(4, "little")


def compress(data) -> bytes:
    """Encode one Snappy stream (greedy hash matcher over 64 KB blocks)."""
    view = memoryview(data)
    n = len(view)
    out = bytearray(write_varint(n))
    for block_start in range(0, n, _BLOCK_SIZE):
        _compress_block(out, view, block_start,
                        min(n - block_start, _BLOCK_SIZE))
    return bytes(out)


def _compress_block(out: bytearray, data: memoryview, base: int,
                    size: int) -> None:
    if size < 15:  # too small to find 4-byte matches profitably
        _emit_literal(out, data, base, size)
        return
    table_bits = 8
    while (1 << table_bits) < size and table_bits < _MAX_HASH_BITS:
        table_bits += 1
    shift = 32 - table_bits
    table = [0] * (1 << table_bits)  # (pos - base) + 1; 0 = empty
    end = base + size
    limit = end - 4  # last position a 4-byte match can start
    ip = base
    lit_start = base
    u32 = int.from_bytes(data[ip: ip + 4], "little")
    while True:
        # Scan for a match, skipping faster the longer it fails (snappy's
        # 32-step skip heuristic).
        skip = 32
        while True:
            h = _hash(u32, shift)
            candidate = table[h] - 1
            table[h] = (ip - base) + 1
            if candidate >= 0 and int.from_bytes(
                    data[base + candidate: base + candidate + 4],
                    "little") == u32:
                candidate += base
                break
            bytes_between = skip >> 5
            skip += 1
            ip += bytes_between
            if ip > limit:
                if lit_start < end:
                    _emit_literal(out, data, lit_start, end - lit_start)
                return
            u32 = int.from_bytes(data[ip: ip + 4], "little")
        if ip > lit_start:
            _emit_literal(out, data, lit_start, ip - lit_start)
        match_len = 4
        while (ip + match_len < end
               and data[ip + match_len] == data[candidate + match_len]):
            match_len += 1
        _emit_copy(out, ip - candidate, match_len)
        ip += match_len
        lit_start = ip
        if ip > limit:
            if lit_start < end:
                _emit_literal(out, data, lit_start, end - lit_start)
            return
        u32 = int.from_bytes(data[ip: ip + 4], "little")
