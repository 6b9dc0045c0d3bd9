"""Texture-plane ops of the Hap Q path as torch ops (layout, YCoCg, BC4,
BC1). Word planes are int32 tensors holding the uint32 bit patterns: torch
has no uint32 arithmetic on the CPU, so every shift that could see bit 31
is masked."""
