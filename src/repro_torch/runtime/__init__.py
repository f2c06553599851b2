"""Runtime support of the DSE service: heartbeats, straggler detection and
fault injection."""
from .ft import FaultInjector, HeartbeatMonitor, StragglerDetector

__all__ = ["HeartbeatMonitor", "StragglerDetector", "FaultInjector"]
