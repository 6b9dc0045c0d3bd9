"""Snappy second stage: the LZ planner (torch ops) with its CUDA emission
and decode kernels, the structured RLE profile with its CUDA compaction and
unit-walk kernels, the frame stitch and raw-chunk copy kernels, the
general decode kernel and the op-table executor kernel of the foreign
path with its host op-table compiler, and a host-side pure-Python codec
used as an independent check and to write foreign-format streams."""
