"""Runtime support: heartbeats, straggler detection and fault injection
(the DSE service), and the fault-tolerant training loop."""
from .ft import (FaultInjector, FaultTolerantLoop, HeartbeatMonitor,
                 LoopResult, StragglerDetector)

__all__ = ["HeartbeatMonitor", "StragglerDetector", "FaultInjector",
           "FaultTolerantLoop", "LoopResult"]
