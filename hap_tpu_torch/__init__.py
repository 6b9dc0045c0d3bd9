"""PyTorch/CUDA port of hap_tpu: the Hap Q + LZ Snappy main path on one GPU.

The JAX package ``hap_tpu`` is the reference. This package imports nothing
from it: the constants, layouts and planners it needs are its own copies,
the texture codecs are torch ops, and the four byte-plane kernels of the
main path are hand-written CUDA C++ (``csrc/``, built with nvcc at first
use). Every kernel wrapper runs its plain PyTorch version when it is given
CPU tensors, which is how the tests run without a GPU.

Entry points: ``hap_tpu_torch.pipeline.device_pipeline.encode_pipeline``,
``decode_pipeline`` and ``roundtrip_pipeline``.
"""
