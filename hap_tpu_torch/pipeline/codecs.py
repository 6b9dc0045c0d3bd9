"""Codec table of the port: which texture formats make which Hap codec.

A minimal copy of the reference package's codec table, kept to the one
codec the port decodes, Hap Q (one YCoCg_DXT5 texture). Its texture decode
is ``device_pipeline.decode_blocks``. A frame of any other known format
raises ``NotImplementedError`` naming the format; the parser rejects an
unknown format as a malformed frame (``HapError``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from hap_tpu_torch.constants import FORMAT_NAMES
from hap_tpu_torch.container.parse import parse_frame


@dataclasses.dataclass(frozen=True)
class HapCodec:
    name: str
    texture_formats: Tuple[str, ...]  # FORMAT_NAMES values, texture order

    @property
    def multi_texture(self) -> bool:
        return len(self.texture_formats) > 1


CODECS: Dict[str, HapCodec] = {
    "hap_q": HapCodec("hap_q", ("YCoCg_DXT5",)),
}


def codec_for_frame(frame) -> HapCodec:
    """The codec of an encoded frame, from its texture formats."""
    return codec_for_plan(parse_frame(frame))


def codec_for_plan(plan) -> HapCodec:
    """The codec of a parsed frame (``parse_frame``'s FramePlan)."""
    fmts = tuple(FORMAT_NAMES[t.format_id] for t in plan.textures)
    for spec in CODECS.values():
        if spec.texture_formats == fmts:
            return spec
    raise NotImplementedError(
        f"texture formats {fmts}: only Hap Q (YCoCg_DXT5) frames are ported")
