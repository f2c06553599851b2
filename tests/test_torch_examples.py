"""The port's twins of ``examples/`` (``repro_torch.examples``) on the CPU,
one case per twin.

quickstart, futureproof_whatif and autoshard_tops print what the
reference's scripts print, line for line: the reference's script runs
under ``JAX_PLATFORMS=cpu`` in a subprocess (6–9 s each here), the twin in
this process with ``device="cpu"``.  The mapping search and flexion hold
bit for bit on the CPU, so the two outputs are equal as text.

serve_batched and train_end_to_end draw their params with torch and
sample with torch, which cannot replay ``jax.random``: serve_batched is
checked for its requests (uids, prompt lengths equal to the reference's,
whose prompts come from the same numpy stream), their lengths and its
waves of 4; train_end_to_end at ``--smoke`` for its injected fault's
restart, its final step and finite losses."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300
TRAIN_STEPS = 20


def _reference(script: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(REPO / "examples" / script)],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _twin(name: str, capsys, argv=()):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    capsys.readouterr()
    result = mod.main(list(argv), device="cpu")
    return result, capsys.readouterr().out


def _prints_what_the_reference_prints(name, capsys):
    want = _reference(f"{name}.py")
    _, got = _twin(name, capsys)
    assert got.splitlines() and got == want


def _serve_batched(name, capsys):
    """12 requests of 24 new tokens in 3 waves of 4 (uids in order); every
    token a vocabulary id."""
    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    waves = []
    run_wave = ServeEngine.run_wave

    def counted(self):
        out = run_wave(self)
        waves.append([r.uid for r in out])
        return out

    ServeEngine.run_wave = counted
    try:
        results, out = _twin(name, capsys)
    finally:
        ServeEngine.run_wave = run_wave
    assert waves == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    want = _reference(f"{name}.py").splitlines()
    got = out.splitlines()
    assert got[0].startswith("served 12 requests, 288 tokens")
    assert got[0].endswith("on cpu")
    assert want[0].startswith("served 12 requests, 288 tokens")
    # prompt lengths come from the same numpy stream on both sides
    assert [line.split(" tokens=")[0] for line in got[1:]] == \
        [line.split(" tokens=")[0] for line in want[1:]]
    vocab = get_config("gemma-2b", smoke=True).vocab
    assert [r.uid for r in results] == list(range(12))
    for r in results:
        assert len(r.tokens) == 24 and r.error is None
        assert ((r.tokens >= 0) & (r.tokens < vocab)).all()


def _train_end_to_end(name, capsys):
    """A fault at step TRAIN_STEPS // 2 restarts the loop from its last
    checkpoint, and the run reaches its last step."""
    res, out = _twin(name, capsys, ["--smoke", "--steps", str(TRAIN_STEPS)])
    assert res.restarts == 1 and res.final_step == TRAIN_STEPS
    losses = [m["loss"] for m in res.metrics_history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert f"fault at step {TRAIN_STEPS // 2}" in out
    assert f"done: {TRAIN_STEPS} steps, 1 restarts" in out
    assert out.rstrip().endswith("on cpu")


CASES = {"quickstart": _prints_what_the_reference_prints,
         "futureproof_whatif": _prints_what_the_reference_prints,
         "autoshard_tops": _prints_what_the_reference_prints,
         "serve_batched": _serve_batched,
         "train_end_to_end": _train_end_to_end}


@pytest.mark.parametrize("name", list(CASES))
def test_twin_runs_on_the_cpu(name, capsys):
    CASES[name](name, capsys)


def test_twins_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    import importlib
    for name in CASES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = ["--smoke", "--steps", "2"] if name == "train_end_to_end" \
            else []
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(argv)
