"""Logical-axis sharding over a ``DeviceMesh``: rule tables bind model
annotations to mesh axes (``api``, ``sharding``).  Plus the device pool
(``pool``): round-robin placement of independent campaign chunks over the
CUDA cards of this process (or the one CPU device), and the in-flight
queue that pipelines them."""
from .api import (NamedSharding, P, PartitionSpec, axis_rules, constrain,
                  current_rules, logical_to_spec, spec_to_placements,
                  validate_spec)
from .pool import DevicePool, InFlightQueue, parse_device_spec
from .sharding import (DATA_AXES, DEFAULT_RULES, MODEL_AXIS, batch_spec,
                       cache_shardings, distribute_tree, gather_tree,
                       make_rules, param_shardings)

__all__ = ["axis_rules", "constrain", "current_rules", "logical_to_spec",
           "validate_spec", "spec_to_placements", "NamedSharding", "P",
           "PartitionSpec", "DATA_AXES", "MODEL_AXIS", "DEFAULT_RULES",
           "batch_spec", "cache_shardings", "make_rules", "param_shardings",
           "distribute_tree", "gather_tree", "DevicePool", "InFlightQueue",
           "parse_device_spec"]
