"""Serving sessions: a fixed frame shape, driven a batch at a time.

A ``DeviceSession`` holds one (height, width, codec, chunk_count)
configuration and runs its encode or decode over a batch of frames as a
loop of per-frame pipeline calls queued on the device's stream, with one
host synchronisation per batch: the frames' results come back to the host
together. This is the reference's serving loop (a jitted ``lax.map`` over
the batch); the GOP-batched kernels are separate entry points.

Results are numpy arrays and frame byte strings, for host interop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from hap_tpu_torch.device import resolve_device
from hap_tpu_torch.pipeline.device_pipeline import (
    _check_codec,
    decode_pipeline,
    decode_pipeline_reasons,
    encode_pipeline,
    encode_pipeline_stats,
    roundtrip_pipeline,
)

# decode ok-reason columns (decode_frame_device with_reasons)
DECODE_REASONS = (
    "format_nibble", "compressor_known", "top_length", "tables", "chunks",
)


@dataclass(frozen=True)
class EncodeStats:
    """Per-frame encode observability, summed over texture sections: the
    per-chunk raw fallback (a chunk whose stream is not shorter than it)
    and the whole-frame raw fallback (a frame whose chunked form is not
    shorter than its payload)."""

    frame_bytes: int  # emitted Hap frame length
    input_bytes: int  # texture payload bytes across sections
    chunk_count: int  # chunks across sections
    snappy_chunks: int  # chunks that stayed Snappy-compressed
    raw_chunk_fallbacks: int  # chunks stored raw (incompressible)
    whole_frame_raw_sections: int  # sections stored raw wholesale
    compression_ratio: float  # input_bytes / frame_bytes

    @staticmethod
    def from_rows(rows, frame_len: int) -> "EncodeStats":
        """rows: (T, 6) int32 of ``encode_pipeline_stats``."""
        rows = np.asarray(rows)
        input_bytes = int(rows[:, 0].sum())
        snappy = int(rows[:, 2].sum())
        # a wholly raw section contributes no per-chunk fallbacks
        complex_ccs = int((rows[:, 1] * (1 - rows[:, 4])).sum())
        return EncodeStats(
            frame_bytes=int(frame_len),
            input_bytes=input_bytes,
            chunk_count=int(rows[:, 1].sum()),
            snappy_chunks=snappy,
            raw_chunk_fallbacks=complex_ccs - snappy,
            whole_frame_raw_sections=int(rows[:, 4].sum()),
            compression_ratio=input_bytes / max(int(frame_len), 1),
        )


def _host(tensors) -> List[np.ndarray]:
    """Device tensors -> numpy arrays after one synchronisation."""
    if tensors and tensors[0].is_cuda:
        staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in tensors]
        for h, t in zip(staged, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        tensors = staged
    return [t.numpy() for t in tensors]


class DeviceSession:
    """On-device codec session for a fixed frame shape."""

    def __init__(self, height: int, width: int, codec: str = "hap_q",
                 chunk_count: int = 64, batch: int = 4, effort: str = "high",
                 device="cuda"):
        _check_codec(codec)
        if batch < 1:
            raise ValueError(f"batch {batch}: at least one frame")
        self.height, self.width = height, width
        self.codec = codec
        self.chunk_count = chunk_count
        self.batch = batch
        self.effort = effort
        self.device = resolve_device(device)

    def _run(self, fn, items) -> List[List[np.ndarray]]:
        """fn(item) -> tuple of device tensors, over ``items`` a batch at a
        time; returns, per output, the stacked host arrays of all items."""
        cols = None
        for b in range(0, len(items), self.batch):
            outs = [fn(x) for x in items[b: b + self.batch]]
            host = _host([torch.stack(col) for col in zip(*outs)])
            cols = host if cols is None else [
                np.concatenate([a, h]) for a, h in zip(cols, host)]
        return cols

    def _frames(self, frames) -> list:
        return [f for f in (frames if torch.is_tensor(frames)
                            else np.asarray(frames))]

    def _encode(self, frame):
        return encode_pipeline(frame, self.codec, self.chunk_count,
                               self.effort, self.device)

    def encode(self, frames) -> List[bytes]:
        """(B, H, W, C) pixels -> list of B Hap frame byte strings."""
        bufs, flens = self._run(self._encode, self._frames(frames))
        return [bufs[i, :int(n)].tobytes() for i, n in enumerate(flens)]

    def decode(self, frame_buffers) -> Tuple[np.ndarray, np.ndarray]:
        """(B, F) uint8 frame buffers (zero-padded) -> ((B, H, W, 3)
        pixels, (B,) ok)."""
        img, ok = self._run(lambda fb: decode_pipeline(
            fb, self.height, self.width, self.codec, self.chunk_count,
            self.device), self._frames(frame_buffers))
        return img, ok

    def decode_bytes(self, frames: List[bytes]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """List of Hap frame byte strings -> ((B, H, W, 3) pixels, ok)."""
        fmax = max(len(f) for f in frames)
        padded = np.zeros((len(frames), fmax), np.uint8)
        for i, f in enumerate(frames):
            padded[i, :len(f)] = np.frombuffer(f, np.uint8)
        return self.decode(padded)

    def roundtrip(self, frames):
        """(B, H, W, C) pixels -> ((B, H, W, 3) decoded pixels, (B,) frame
        lengths, (B,) ok)."""
        out, flen, ok = self._run(lambda f: roundtrip_pipeline(
            f, self.codec, self.chunk_count, self.effort, self.device),
            self._frames(frames))
        return out, flen, ok

    def encode_with_stats(self, frames
                          ) -> Tuple[List[bytes], List[EncodeStats]]:
        """``encode`` plus per-frame ``EncodeStats``."""
        bufs, flens, rows = self._run(lambda f: encode_pipeline_stats(
            f, self.codec, self.chunk_count, self.effort, self.device),
            self._frames(frames))
        return ([bufs[i, :int(n)].tobytes() for i, n in enumerate(flens)],
                [EncodeStats.from_rows(rows[i], int(n))
                 for i, n in enumerate(flens)])

    def decode_with_reasons(self, frame_buffers
                            ) -> Tuple[np.ndarray, np.ndarray, List[dict]]:
        """``decode`` plus, per frame, a dict from each ``DECODE_REASONS``
        name to a list of bools, one per texture section."""
        img, ok, reasons = self._run(lambda fb: decode_pipeline_reasons(
            fb, self.height, self.width, self.codec, self.chunk_count,
            self.device), self._frames(frame_buffers))
        dicts = [{name: [bool(x) for x in r[:, j]]
                  for j, name in enumerate(DECODE_REASONS)} for r in reasons]
        return img, ok, dicts
