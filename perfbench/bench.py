"""The harness: finds a cell's files by name, runs it, judges it, and
builds the result line.

A cell of ``BENCHMARK.json`` names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); the mix's ``kind`` names the
driver (``perfbench/kinds/<kind>.py``), and the cell's limits are in
``perfbench/limits/<workload>.json``.  Each per-layer metric is read by
``perfbench/metrics/<metric>.py``.  A configuration's ``family`` (the
``decoder`` where it names none) is ``perfbench/families/<family>.py``:
everything the harness knows of one architecture (the program blocks
it judges, the keys checked against the program, the parameter leaves,
the model FLOPs and the plain reference) is there.  A new cell,
configuration, mix, metric or family is new files and entries only.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib
import time
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HERE = pathlib.Path(__file__).resolve().parent
DEFAULT_FAMILY = "decoder"


def _json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path):
    """A harness module loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_name(conf: Dict) -> str:
    """The model family a configuration file names."""
    return conf.get("family", DEFAULT_FAMILY)


@functools.lru_cache(maxsize=None)
def _family(name: str):
    path = HERE / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no model family {name!r}: {path}")
    return _module(path)


def family(conf: Dict):
    """The family module of configuration ``conf``, loaded once from
    ``perfbench/families/<family>.py`` beside this file.  It provides
    ``BLOCKS`` (the program's ``ModelConfig.block`` values it judges),
    ``FIELDS`` (configuration key -> ``ModelConfig`` field, checked
    before every run), ``check(conf, cfg)`` (its own refusals),
    ``leaves(conf, qk_gain)``, ``train_step_flops(conf, batch, seq)``,
    ``serve_request_flops(conf, prompt, generated)``,
    ``attention_flops(conf, queries, first_key)`` or None where it has
    no attention, and ``reference``, the plain reference module the
    kinds judge with (``Spec.from_config``, ``train``, ``logits_at``)."""
    return _family(family_name(conf))


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    root: pathlib.Path          # the checkout (holds BENCHMARK.json)
    bench: Dict
    workload: Dict
    conf: Dict
    mix: Dict
    limits: Dict

    @classmethod
    def load(cls, root: pathlib.Path, name: str) -> "Cell":
        bench = _json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        here = root / "perfbench"
        return cls(root, bench, w, _json(here / "configs" / f"{w['config']}.json"),
                   _json(here / "traffic" / f"{w['traffic']}.json"),
                   _json(here / "limits" / f"{name}.json"))

    def metrics(self, section: str) -> List[Dict]:
        """The metrics of ``section`` this cell reports."""
        return [m for m in self.bench[section]
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]


class Spans:
    """Device-timeline marks (CUDA events; the host clock on the CPU),
    taken only in a traced run."""

    def __init__(self, device, on: bool):
        import torch
        self.on = on
        self.cuda = torch.device(device).type == "cuda"
        self.marks: Dict[str, List] = {}

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.cuda:
            import torch
            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.marks.setdefault(name, []).append(e)

    def wrap(self, name: str, fn: Callable) -> Callable:
        def wrapped(*args):
            self.mark(name + ".start")
            out = fn(*args)
            self.mark(name + ".end")
            return out
        return wrapped

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


@dataclasses.dataclass
class Run:
    """What a kind's driver is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    hooks: Dict = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def before_window(self) -> None:
        """Fails the run if anything of JAX or the JAX package is loaded."""
        import sys
        found = forbidden_modules(sys.modules)
        if found:
            raise RuntimeError(f"loaded before the window: {found}")


def free() -> None:
    """Return the freed device memory to the card."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_kind(device) -> str:
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def note(text: str) -> None:
    """A line of progress on standard error."""
    import sys
    print(f"perfbench: {text}", file=sys.stderr, flush=True)


def profile(device):
    """A ``torch.profiler`` over the host's operators and, on a card, the
    device's kernels and copies."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             hooks: Optional[Dict] = None) -> Dict:
    """Run one cell and return the result line's object."""
    import torch
    cell = Cell.load(root, workload)
    here = root / "perfbench"
    kind = _module(here / "kinds" / f"{cell.mix['kind']}.py")
    run = Run(cell, seed, seconds, trace, device, t_start, hooks or {})
    out = kind.run(run)
    units = {m["name"]: m["unit"] for section in ("end_to_end", "per_layer")
             for m in cell.bench[section]}
    metrics = {}
    if trace:
        for m in cell.metrics("per_layer"):
            value = _module(here / "metrics" / f"{m['name']}.py").read(
                out["observed"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        # a driver reports each quantity once; a cell's metric of it may
        # carry a suffix of its own (train_tokens_per_s.moe)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {
                "value": out["end_to_end"][m["name"].split(".")[0]],
                "unit": units[m["name"]]}
    dev = torch.device(device)
    chips = cell.workload["chips"]
    result = {
        "correct": bool(out["ok"] and all(c["ok"] for c in
                                          out["checks"].values())),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": device_kind(dev),
                   "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    summary = out["observed"].get("trace")
    if trace and summary is not None:
        result["device"]["busy_s"] = summary["busy_s"] / chips
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                        for n, c in out["checks"].items()}
    return result
