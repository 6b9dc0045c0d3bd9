"""On-device pixel <-> Hap frame pipelines (Hap Q).

encode: pixels -> block planes -> scaled YCoCg -> BC4 (Y) + BC1 (CoCg)
words -> word interleave -> Snappy streams -> container stitch (kernel B).
decode: frame parse -> raw chunks (kernel D) and Snappy chunks straight
out of the frame -> word de-interleave -> BC4 + BC1 decode -> RGB. The
Snappy streams follow the LZ profile (LZ plan, emission kernel A, walk
kernel C) or, with ``HAP_TPU_DEVICE_LZ=0``, the structured RLE profile
(compaction kernel E, walk kernel D(ii)); see ``device_frame``.
Everything stays on the device; the entry points return device tensors
without synchronising.

Only the ``hap_q`` codec is ported. Frames below 8192 rows take the direct
path; the reference's tall-frame slabbing is an XLA workaround that the
port does not need.
"""

from __future__ import annotations

import numpy as np
import torch

from hap_tpu_torch.constants import (
    FORMAT_YCOCG_DXT5,
    HAP_Q_BLOCK_BYTES,
    dxt_payload_bytes,
    legalize_chunk_count,
)
from hap_tpu_torch.device import resolve_device
from hap_tpu_torch.kernels.bc1 import bc1_decode_planes, bc1_encode_planes_words
from hap_tpu_torch.kernels.bc4 import bc4_decode_planes, bc4_encode_planes_words
from hap_tpu_torch.kernels.layout import (
    block_planes_to_image,
    deinterleave_words,
    image_to_block_planes,
    interleave_words,
    words_to_payload,
)
from hap_tpu_torch.kernels.ycocg import (
    cocgs_y_to_rgb_planes,
    rgb_to_cocgs_y_planes,
)
from hap_tpu_torch.pipeline.device_frame import (
    decode_frame_device,
    encode_frame_device,
    encode_frame_device_stats,
)
from hap_tpu_torch.reference_state import encode_settings

_G = HAP_Q_BLOCK_BYTES


def _check_codec(codec: str) -> None:
    if codec != "hap_q":
        raise NotImplementedError(f"codec {codec!r}: only 'hap_q' is ported")


def _on(x, device) -> torch.Tensor:
    """numpy array or tensor -> tensor on the resolved device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.require(x, requirements=["C", "W"]))
    return x.to(resolve_device(device))


def plan_chunks(height: int, width: int, chunk_count: int) -> int:
    """Legal chunk count of a Hap Q frame (the reference encoder's rule)."""
    return legalize_chunk_count(dxt_payload_bytes(width, height, _G), _G,
                                chunk_count)


def encode_blocks(img: torch.Tensor, effort: str = "high") -> torch.Tensor:
    """(H, W, C>=3) uint8 -> (N*4,) int32 payload words, block-major
    [BC4 w0, BC4 w1, BC1 w0, BC1 w1] per block."""
    refine_iters, candidates = encode_settings(effort)
    cocgs, y = rgb_to_cocgs_y_planes(image_to_block_planes(img[..., :3]))
    y0, y1 = bc4_encode_planes_words(y, candidates=candidates)
    c0, c1 = bc1_encode_planes_words(cocgs, refine_iters=refine_iters,
                                     candidates=candidates)
    return interleave_words((y0, y1, c0, c1))


def decode_blocks(words: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """(N*4,) int32 payload words -> (H, W, 3) uint8 RGB."""
    y0, y1, c0, c1 = deinterleave_words(words.reshape(-1), 4)
    cocgs, _ = bc1_decode_planes(c0, c1, dxt1_punchthrough=False)
    y = bc4_decode_planes(y0, y1)
    return block_planes_to_image(cocgs_y_to_rgb_planes(cocgs, y), height,
                                 width)


def encode_words(words: torch.Tensor, height: int, width: int,
                 chunk_count: int = 64):
    """Payload words -> ((fmax,) uint8 frame, () int32 frame length)."""
    cc = plan_chunks(height, width, chunk_count)
    return encode_frame_device(words_to_payload(words), cc, FORMAT_YCOCG_DXT5,
                               _G, row_bytes=_G * width // 4)


def encode_pipeline(img, codec: str = "hap_q", chunk_count: int = 64,
                    effort: str = "high", device="cuda"):
    """(H, W, C>=3) uint8 pixels (numpy or tensor) -> ((fmax,) uint8 frame
    buffer, () int32 frame length) on ``device``. The chunk count is
    legalized against the payload size as the reference encoder does."""
    _check_codec(codec)
    img = _on(img, device)
    h, w = img.shape[0], img.shape[1]
    return encode_words(encode_blocks(img, effort), h, w, chunk_count)


def encode_pipeline_stats(img, codec: str = "hap_q", chunk_count: int = 64,
                          effort: str = "high", device="cuda"):
    """``encode_pipeline`` plus per-texture stats: (frame, frame length,
    (T, 6) int32), one row per texture section (T = 1 for Hap Q):
    [input_bytes, chunk_count, Snappy chunks, payload bytes stored,
    whole-frame raw (0/1), section frame length]. The compression ratio and
    the per-chunk raw fallbacks follow from them."""
    _check_codec(codec)
    img = _on(img, device)
    h, w = img.shape[0], img.shape[1]
    cc = plan_chunks(h, w, chunk_count)
    frame, flen, stats = encode_frame_device_stats(
        words_to_payload(encode_blocks(img, effort)), cc, FORMAT_YCOCG_DXT5,
        _G, row_bytes=_G * w // 4)

    def const(v):  # a device scalar without a host-to-device copy
        return torch.full((1,), v, dtype=torch.int32, device=img.device)

    row = torch.cat([const(dxt_payload_bytes(w, h, _G)), const(cc), stats,
                     flen[None]])
    return frame, flen, row[None]


def decode_pipeline(frame, height: int, width: int, codec: str = "hap_q",
                    chunk_count: int = 64, device="cuda"):
    """((F,) uint8 frame bytes, dims) -> ((H, W, 3) uint8 pixels, () bool
    ok) on ``device``. ok=False flags a frame outside the layout or stream
    profile this decoder accepts."""
    return _decode(frame, height, width, codec, chunk_count, device, False)


def decode_pipeline_reasons(frame, height: int, width: int,
                            codec: str = "hap_q", chunk_count: int = 64,
                            device="cuda"):
    """``decode_pipeline`` plus a (T, 5) int32 ok-reason matrix, one row
    per texture section (T = 1 for Hap Q); its columns are those of
    ``decode_frame_device(with_reasons=True)``."""
    img, ok, reasons = _decode(frame, height, width, codec, chunk_count,
                               device, True)
    return img, ok, reasons[None]


def _decode(frame, height, width, codec, chunk_count, device, with_reasons):
    _check_codec(codec)
    frame = _on(frame, device)
    nbytes = dxt_payload_bytes(width, height, _G)
    cc = plan_chunks(height, width, chunk_count)
    words, *rest = decode_frame_device(frame, nbytes, cc, FORMAT_YCOCG_DXT5,
                                       _G, out_words=True,
                                       with_reasons=with_reasons)
    return (decode_blocks(words, height, width), *rest)


def roundtrip_pipeline(img, codec: str = "hap_q", chunk_count: int = 64,
                       effort: str = "high", device="cuda"):
    """Encode then decode on ``device`` -> (decoded image, frame length,
    ok)."""
    img = _on(img, device)
    h, w = img.shape[0], img.shape[1]
    frame, frame_len = encode_pipeline(img, codec, chunk_count, effort,
                                       img.device)
    out, ok = decode_pipeline(frame, h, w, codec, chunk_count, img.device)
    return out, frame_len, ok
