"""PyTorch/CUDA port of hap_tpu: Hap Q on one GPU.

The JAX package ``hap_tpu`` is the reference. This package imports nothing
from it: the constants, layouts, planners and host codecs it needs are its
own copies, the texture codecs are torch ops, and the byte-plane kernels
are hand-written CUDA C++ (``csrc/``, built with nvcc at first use). Every
kernel wrapper runs its plain PyTorch version when it is given CPU
tensors, which is how the tests run without a GPU.

Entry points: the Hap Q main path,
``hap_tpu_torch.pipeline.device_pipeline.encode_pipeline``,
``decode_pipeline`` and ``roundtrip_pipeline``, with
``encode_pipeline_stats`` and ``decode_pipeline_reasons``; the serving
session ``hap_tpu_torch.pipeline.DeviceSession``; the decode of Hap Q
frames from any encoder, ``hap_tpu_torch.pipeline.any_frame``:
``decode_frame_any_device``, ``decode_frame_any`` and
``ForeignGopSession``. The Snappy second stage is the LZ profile, or the
structured RLE profile when the environment sets ``HAP_TPU_DEVICE_LZ=0``.
"""
