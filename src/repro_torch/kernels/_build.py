"""Build the CUDA sources under ``csrc/`` and load them with ``ctypes``.

At first use a ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``)
into a shared library with a plain C interface (:func:`build_all` compiles
every source, one ``nvcc`` each, all started together).  Libraries land
in ``build/`` beside this file (listed in ``.gitignore``), named by a hash
of the source and flags, so an edited source is rebuilt and an unchanged
one is reused.  ``ptxas`` reports (registers, shared memory, spills) are
kept next to each library.

Nothing here runs at import time: the package imports on a machine
without ``nvcc`` or a card, where only the plain versions run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every source (or the sources of ``names``) whose library is
    missing, in parallel; returns ``{source stem: library path}``.  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src))
               for src in sorted(CSRC.glob("*.cu"))
               if names is None or src.stem in names}
    procs = {}
    for name, (src, lib) in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: lib for name, (_, lib) in targets.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it alone at first
    use (a process that runs one kernel compiles one source)."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build_all((name,))[name]))
        return _LIBS[name]


def build_log(name: str) -> str:
    """The ``nvcc``/``ptxas`` output of the library's build (empty when the
    library was built by an earlier process and its log is gone)."""
    log = _target(CSRC / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""
