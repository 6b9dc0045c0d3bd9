"""Snappy second stage of the Hap Q main path: the LZ planner (torch ops),
its CUDA emission and decode kernels, the frame stitch and raw-chunk copy
kernels, and a host-side pure-Python codec used as an independent check."""
