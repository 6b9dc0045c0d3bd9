"""Frame assembly/parse, the pixel <-> frame pipelines and the serving
session of the port."""

from hap_tpu_torch.pipeline.session import DeviceSession

__all__ = ["DeviceSession"]
