"""Pixel <-> 4x4-block layout transforms and byte/word packing.

S3TC stores a frame as raster-ordered 4x4 texel blocks; blocks are (N, 16,
C) with texels in row-major order, or lane-major (C, 16, N) planes. Odd
frame sizes are edge-replicated on encode and cropped on decode. On the GPU
every transform here is a reshape/permute copy or a byte view: the word
interleave that the reference runs as one-hot matrix products is a strided
view here.

Words are int32 tensors holding uint32 bit patterns; the byte views rely on
a little-endian host and device, as the Hap payload is little-endian.
"""

from __future__ import annotations

import torch


def padded_dims(height: int, width: int) -> tuple:
    return ((height + 3) // 4) * 4, ((width + 3) // 4) * 4


def _edge_pad(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (PH, PW, C) with edge replication."""
    h, w = img.shape[0], img.shape[1]
    ph, pw = padded_dims(h, w)
    if (ph, pw) == (h, w):
        return img
    rows = torch.arange(ph, device=img.device).clamp_(max=h - 1)
    cols = torch.arange(pw, device=img.device).clamp_(max=w - 1)
    return img[rows][:, cols]


def image_to_blocks(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) or (H, W) -> (N, 16[, C]) with edge-replication padding."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    img = _edge_pad(img)
    ph, pw, c = img.shape
    bh, bw = ph // 4, pw // 4
    blocks = img.reshape(bh, 4, bw, 4, c).permute(0, 2, 1, 3, 4)
    blocks = blocks.reshape(bh * bw, 16, c)
    return blocks[..., 0] if squeeze else blocks


def blocks_to_image(blocks: torch.Tensor, height: int, width: int
                    ) -> torch.Tensor:
    """(N, 16[, C]) -> (H, W[, C]), cropping any edge-block padding."""
    squeeze = blocks.dim() == 2
    if squeeze:
        blocks = blocks[..., None]
    c = blocks.shape[-1]
    ph, pw = padded_dims(height, width)
    bh, bw = ph // 4, pw // 4
    img = blocks.reshape(bh, bw, 4, 4, c).permute(0, 2, 1, 3, 4)
    img = img.reshape(ph, pw, c)[:height, :width]
    return img[..., 0] if squeeze else img


def words_to_payload(words: torch.Tensor) -> torch.Tensor:
    """Any-shape int32 words -> (4k,) uint8 little-endian payload (a view
    when ``words`` is contiguous)."""
    return words.contiguous().reshape(-1).view(torch.uint8)


def payload_to_words(payload: torch.Tensor) -> torch.Tensor:
    """(4k,) uint8 little-endian payload -> (k,) int32 words (a view)."""
    if payload.numel() % 4:
        raise ValueError(f"payload of {payload.numel()} bytes is not whole words")
    return payload.contiguous().view(torch.int32)


def interleave_words(ws) -> torch.Tensor:
    """k word planes ((N,) each) -> (k*N,) payload words, block-major:
    out[k*b + j] = ws[j][b]."""
    return torch.stack(list(ws), dim=1).reshape(-1)


def deinterleave_words(flat: torch.Tensor, k: int):
    """(k*N,) payload words -> k (N,) word planes (inverse of
    interleave_words)."""
    cols = flat.reshape(-1, k)
    return tuple(cols[:, j] for j in range(k))


def image_to_block_planes(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) or (H, W) -> (C, 16, N) uint8 lane-major block planes, in
    the block (N) and texel (t = 4*row + col) order of image_to_blocks."""
    if img.dim() == 2:
        img = img[..., None]
    img = _edge_pad(img)
    ph, pw, c = img.shape
    bh, bw = ph // 4, pw // 4
    planes = img.reshape(bh, 4, bw, 4, c).permute(4, 1, 3, 0, 2)
    return planes.reshape(c, 16, bh * bw)


def block_planes_to_image(planes: torch.Tensor, height: int, width: int
                          ) -> torch.Tensor:
    """(C, 16, N) planes -> (H, W[, C]) (inverse of image_to_block_planes);
    a single-channel result drops the channel axis."""
    c = planes.shape[0]
    ph, pw = padded_dims(height, width)
    bh, bw = ph // 4, pw // 4
    img = planes.reshape(c, 4, 4, bh, bw).permute(3, 1, 4, 2, 0)
    img = img.reshape(ph, pw, c)[:height, :width]
    return img[..., 0] if c == 1 else img


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)
