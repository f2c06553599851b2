"""The device pool (``pool``): round-robin placement of independent
campaign chunks over the CUDA cards of this process (or the one CPU
device), and the in-flight queue that pipelines them."""
from .pool import DevicePool, InFlightQueue, parse_device_spec

__all__ = ["DevicePool", "InFlightQueue", "parse_device_spec"]
