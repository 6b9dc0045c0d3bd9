"""Frame assembly/parse and the pixel <-> frame pipelines of the port."""
