"""The flexibility classes (paper Sec 3.2, Fig 2a).

Class vector [X_T, X_O, X_P, X_S]: axis bit is 1 iff the accelerator supports
more than one mapping choice along that axis (Eq. 1).  This repo extends the
taxonomy with a fifth representation axis R ([X_T, X_O, X_P, X_S, X_R] — 32
classes in ``ALL_CLASSES_5``); the paper's 16-class T/O/P/S taxonomy stays in
``ALL_CLASSES``.  Includes the paper's best-effort classification of prior
accelerators for the taxonomy tests and the README table.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .spec import FlexSpec


def class_id(vec: Tuple[int, ...]) -> int:
    """Bit-pack a class vector of any width (4 = T/O/P/S, 5 = +R)."""
    cid = 0
    for b in vec:
        cid = (cid << 1) | int(b)
    return cid


def class_vector(cid: int, width: int = 4) -> Tuple[int, ...]:
    return tuple((cid >> (width - 1 - i)) & 1 for i in range(width))


def class_str(cid: int, width: int = 4) -> str:
    return "".join(str(b) for b in class_vector(cid, width))


ALL_CLASSES = tuple(class_str(i) for i in range(16))
ALL_CLASSES_5 = tuple(class_str(i, 5) for i in range(32))


# Paper Fig 2(a): best-effort classification of prior accelerators.
# vector = (T, O, P, S)
PRIOR_WORK: Dict[str, Tuple[int, int, int, int]] = {
    "NVDLA":        (0, 0, 0, 0),   # fixed dataflow, fixed tiles
    "TPU-v3":       (1, 0, 0, 0),   # compiler-tiled, fixed systolic dataflow
    "ShiDianNao":   (0, 0, 0, 0),
    "Eyeriss":      (1, 0, 0, 1),   # row-stationary, limited logical remap
    "Eyeriss_v2":   (1, 0, 1, 1),   # adds flexible spatial partitioning
    "FlexFlow":     (1, 1, 1, 0),   # flexible dataflow orders/parallelism
    "MAERI":        (1, 1, 1, 1),   # reconfigurable interconnects: full TOPS
    "SIGMA":        (1, 1, 1, 1),
    "Planaria":     (1, 0, 1, 1),   # dynamic architecture fission
    "Simba":        (1, 0, 1, 0),
}


def classify(spec: FlexSpec) -> str:
    return spec.class_str()


def describe(spec: FlexSpec) -> str:
    names = ("T", "O", "P", "S", "R")
    vec = spec.class_vector()
    on = [n for n, b in zip(names, vec) if b]
    return (f"{spec.name}: class-{spec.class_str()} "
            f"(flexible axes: {'+'.join(on) if on else 'none'})")
