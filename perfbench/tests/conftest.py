"""Fixtures of the harness's own tests: a copy of the benchmark with tiny
cells of each kind, run on the CPU."""
import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for p in (REPO, REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=4, head_dim=16, vocab_size=512)
PORT_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, vocab=512)
# limits of the tiny cells, from CPU readings at these sizes: sound runs
# read grad_gap <= 0.016, change_gap <= 0.006, logit_gap <= 0.011; half
# a batch reads change_gap >= 0.14, an unchanged state 1, an altered
# token logit_gap >= 4
TINY_LIMITS = {"train": {"grad_gap": 0.1, "change_gap": 0.05},
               "serve": {"logit_gap": 0.5}}
TINY_CELLS = {"tiny-dense.train": ("tiny-dense", "tiny-train"),
              "tiny-moe.train": ("tiny-moe", "tiny-train"),
              "tiny-dense.serve": ("tiny-dense", "tiny-serve")}


def copy_benchmark(dst: pathlib.Path) -> pathlib.Path:
    """The committed benchmark (BENCHMARK.json and perfbench/) under
    ``dst``, with the program beside it."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "src").symlink_to(REPO / "src")
    return dst


def _write(path: pathlib.Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


PB_CONFIGS = {p.stem: p for p in (REPO / "perfbench" / "configs").glob("*.json")}


def tiny_conf(name: str, dtype: str = "bfloat16", **extra) -> dict:
    """A committed configuration cut to a tiny size: ``tiny-dense`` from
    stablelm-3b, ``tiny-moe`` from olmoe-1b-7b."""
    if name == "tiny-dense":
        conf = json.loads(PB_CONFIGS["stablelm-3b"].read_text())
        conf.update(SMALL, name=name, intermediate_size=128,
                    torch_dtype=dtype,
                    port={"arch": "stablelm-3b", "overrides": dict(
                        PORT_SMALL, d_ff=128, dtype=dtype)})
    else:
        conf = json.loads(PB_CONFIGS["olmoe-1b-7b"].read_text())
        conf.update(SMALL, name=name, intermediate_size=32, num_experts=8,
                    num_experts_per_tok=2, torch_dtype=dtype,
                    port={"arch": "olmoe-1b-7b", "overrides": dict(
                        PORT_SMALL, d_ff=32, n_experts=8, top_k=2,
                        dtype=dtype)})
    conf.update(extra)
    conf["port"]["overrides"].update(
        {"capacity_factor": extra["capacity_factor"]}
        if "capacity_factor" in extra else {})
    return conf


def add_tiny_cells(root: pathlib.Path, dtype: str = "bfloat16") -> None:
    """Tiny configurations, mixes and cells of the committed kinds, with
    the committed cells' limits."""
    pb = root / "perfbench"
    read = lambda p: json.loads((pb / p).read_text())
    for name in ("tiny-dense", "tiny-moe"):
        _write(pb / "configs" / f"{name}.json", tiny_conf(name, dtype))
    train = read("traffic/train-4x4096.json")
    train.update(seq_len=64, pool_batches=4)
    _write(pb / "traffic/tiny-train.json", train)
    serve = read("traffic/serve-longprompt.json")
    serve.update(wave_size=4, max_len=96, backlog=8, prompt_min=8,
                 prompt_max=80, new_tokens=4, pool_waves=4,
                 check_requests=4)
    _write(pb / "traffic/tiny-serve.json", serve)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (conf, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": mix, "chips": 1, "why": "tiny"})
        big = ("stablelm-3b.serve-longprompt" if "serve" in name
               else "stablelm-3b.train-4x4096")
        _write(pb / "limits" / f"{name}.json",
               TINY_LIMITS["serve" if "serve" in name else "train"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            if big in m.get("workloads", []):
                m["workloads"].append(name)
    _write(root / "BENCHMARK.json", bench)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    root = copy_benchmark(tmp_path_factory.mktemp("checkout"))
    add_tiny_cells(root)
    return root


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
