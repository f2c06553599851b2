"""The one door to the program under test, ``repro_torch``.

The harness takes from the program its configuration registry, its
train step and optimizer, and its serving engine; nothing else.  Each
configuration file names the program's architecture and the fields it
changes there.  Before a run, the configuration's model family
(``perfbench/families/<family>.py``, where the architecture-specific
code lives) must judge the program's block, and every size the file
states under the family's ``FIELDS`` is checked against the program's
configuration, so the two cannot drift apart.
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict

from perfbench import bench

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _import():
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails where the program is absent)


def config(conf: Dict):
    """The program's ModelConfig of ``conf``, checked by its family: the
    program's block, each field of ``FIELDS``, then the family's own
    ``check``."""
    _import()
    from repro_torch.configs import get_config
    family = bench.family(conf)
    port = conf["port"]
    cfg = get_config(port["arch"]).replace(**port.get("overrides", {}))
    if cfg.block not in family.BLOCKS:
        raise ValueError(
            f"{conf['name']}: the program runs block {cfg.block!r}, which "
            f"the {bench.family_name(conf)!r} family does not judge "
            f"(it judges {', '.join(family.BLOCKS)})")
    for key, field in family.FIELDS.items():
        if key in conf and getattr(cfg, field) != conf[key]:
            raise ValueError(f"{conf['name']}: {key} {conf[key]!r} but the "
                             f"program runs {field}={getattr(cfg, field)!r}")
    family.check(conf, cfg)
    return cfg


def train_step(cfg):
    """(step_fn, optimizer, TrainState) of the program's default training
    path for ``cfg``."""
    _import()
    from repro_torch.launch import steps
    opt = steps.default_optimizer(cfg)
    return steps.make_train_step, opt, steps.TrainState


def serve_engine():
    _import()
    from repro_torch.serve.engine import Request, ServeEngine
    return ServeEngine, Request
