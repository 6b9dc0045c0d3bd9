"""Pure-Python Snappy decompressor: an independent host-side check.

A copy of the reference package's strict decoder (any malformed stream
raises HapError). It shares no code with the port's CUDA decode kernel and
accepts every conforming Snappy stream (copy-1/2/4, 1-5 byte literal
headers), so it can verify the port's streams byte for byte.
"""

from __future__ import annotations

from hap_tpu_torch.constants import HapError


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
