"""The port's sharded steps on a (2, 2) mesh of 4 gloo ranks against the
reference's own sharded steps on 4 host devices, on the CPU.

Both sides run once a module, in parallel subprocesses
(``tests/_torch_dist_mesh.py``): the reference's ``jit_train_step``,
``jit_prefill_step`` and ``jit_serve_step`` on a ('data', 'model') mesh
built with Auto axes, and the port's on a ``DeviceMesh`` over a gloo
process group from a ``FileStore`` under the test's temporary directory.
Each case is a test of its own.  Tolerances: losses 1e-5 relative,
params 1e-4 of a leaf's largest entry, logits 2e-4 absolute (float32
throughout; the meshes sum partial products in other orders than one
device does).

* Train, 3 AdamW steps: gemma-2b smoke with FSDP and sequence-sharded
  activations off and on, olmoe-1b-7b (both sides through the MoE
  all-to-all, counted), falcon-mamba-7b and zamba2-2.7b.  A control: the
  one-device olmoe step differs from the (2, 2) reference beyond the
  tolerances (the all-to-all routes with a per-shard capacity and averages
  a per-shard aux loss), so the comparison does see that path.  And
  olmoe-1b-7b on 2 x 8 tokens, too few for the all-to-all: the port's
  scatter path on the mesh (each rank runs its own experts), with its
  gradients, against the reference's.
* Serve: a prefill and 3 decode steps of gemma-2b and olmoe-1b-7b.
* ``_moe_block_a2a`` alone: output, aux and gradients against
  ``jax.grad`` of the reference's.
* The attention core on local shards: MHA, GQA, MQA and heads that do
  not split (q's positions split instead), dense and the flash twin,
  forward and backward, against one device.
* The vocab-parallel loss: on logits sharded over 'model' by vocab, and
  through ``loss_fn`` on gemma-2b's sharded params, the loss and its
  gradients equal the plain loss's on the whole tensors.
* On the mesh against the port's one-device steps: ``n_micro=2`` and an
  Adafactor step; ``run_training`` over (2, 2) with a fault at step 3
  against a fault-free one-device run.
* Elastic restore: a checkpoint written on (2, 2) restores onto (4, 1)
  and onto one device bit for bit, each rank holding only its shards, and
  its files are byte-equal to a one-device save of the same state.
* A 1x1 mesh (one gloo rank): the sharded train steps equal the
  one-device steps bit for bit; prefill and decode within 2e-4.
* The launcher's CLI under ``torchrun`` (2 processes, gloo): ``--dp 2``
  trains over a (2, 1) mesh, and only rank 0 prints.
"""
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_mesh as M  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL, PARAM_TOL, LOGIT_ATOL = 1e-5, 1e-4, 2e-4
TIMEOUT = 420


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference, the 4 ranks and the 1x1 rank together; returns
    (reference dir, port dir, 1x1 dir)."""
    root = tmp_path_factory.mktemp("dist")
    ref, port, one = (root / n for n in ("ref", "port", "one"))
    for d in (ref, port, one):
        d.mkdir()
    script = str(REPO / "tests" / "_torch_dist_mesh.py")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    jobs = [subprocess.Popen([sys.executable, script, "reference", str(ref)],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)]
    jobs += [subprocess.Popen([sys.executable, script, "rank", str(r), "4",
                               str(root / "store"), str(port)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    jobs.append(subprocess.Popen([sys.executable, script, "one", str(one)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))
    failed = []
    try:
        for job in jobs:
            _, err = job.communicate(timeout=TIMEOUT)
            if job.returncode != 0:
                failed.append(err[-3000:])
    finally:
        for job in jobs:
            if job.poll() is None:
                job.kill()
                job.communicate()
    assert not failed, failed[0]
    return ref, port, one


def _load(d, name):
    return np.load(os.path.join(d, name.replace(" ", "_") + ".npz"))


def _leaf_gaps(got, want, prefix="p:"):
    """Each param leaf's largest gap as a share of its largest entry."""
    keys = sorted(k for k in want.files if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got.files
                                   if k.startswith(prefix))
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in keys}


@pytest.mark.parametrize("name,arch,over", M.TRAIN,
                         ids=[n for n, _, _ in M.TRAIN])
def test_train_steps_equal_the_reference(runs, name, arch, over):
    ref, port, _ = runs
    want, got = _load(ref, f"ref {name}"), _load(port, f"port {name}")
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=LOSS_RTOL,
                               atol=1e-7)
    gaps = _leaf_gaps(got, want)
    assert max(gaps.values()) <= PARAM_TOL, gaps
    a2a = name == "olmoe-1b-7b"
    assert (int(want["a2a"]) > 0) == a2a and (int(got["a2a"]) > 0) == a2a
    assert (int(got["scatter"]) > 0) == (name == "olmoe-1b-7b scatter")


def test_one_device_moe_step_differs_from_the_mesh(runs):
    """The control: without the all-to-all's per-shard routing the olmoe
    losses and aux leave the tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw

    cfg = get_config("olmoe-1b-7b", smoke=True)
    opt = adamw(M.LR)
    losses, auxes, _ = M._port_train(cfg, lambda b: make_train_step(cfg, opt),
                                     opt)
    want = _load(runs[0], "ref olmoe-1b-7b")
    assert np.max(np.abs(np.array(losses) - want["losses"])
                  / want["losses"]) > 10 * LOSS_RTOL
    assert np.max(np.abs(np.array(auxes) - want["aux"])
                  / want["aux"]) > 10 * LOSS_RTOL


@pytest.mark.parametrize("arch", M.SERVE)
def test_prefill_and_decode_equal_the_reference(runs, arch):
    ref, port, _ = runs
    want = _load(ref, f"ref serve {arch}")
    got = _load(port, f"port serve {arch}")
    assert got["logits"].shape == want["logits"].shape \
        == (1 + M.DECODE, M.BATCH, got["logits"].shape[-1])
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGIT_ATOL)
    moe = arch == "olmoe-1b-7b"          # the prefill's 64 tokens: a2a
    assert (int(want["a2a"]) > 0) == moe and (int(got["a2a"]) > 0) == moe
    # the decode steps' 4 tokens: the scatter path, experts sharded
    assert (int(got["scatter"]) > 0) == moe


def test_a2a_block_and_its_grads_equal_jax_grad(runs):
    ref, port, _ = runs
    want, got = _load(ref, "ref a2a"), _load(port, "port a2a")
    keys = ["y", "aux", "gx", "g:router", "g:w_down", "g:w_gate", "g:w_up"]
    assert sorted(want.files) == sorted(got.files) == sorted(keys)
    for k in keys:
        tol = 1e-5 * max(float(np.abs(want[k]).max()), 1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)
    assert float(want["aux"]) > 0 and np.abs(want["g:router"]).max() > 0


def test_vocab_parallel_loss_equals_the_plain_loss(runs):
    """On logits whose vocab is sharded over 'model' (and batch over
    'data'), ``token_nll``'s mean and its gradient on the logits, and
    ``loss_fn``'s value and param gradients on the sharded params, against
    the same on the plain whole tensors: losses at 1e-5 relative,
    gradients at 1e-4 of a leaf's largest entry."""
    got = _load(runs[1], "port vocab loss")
    assert bool(got["vocab_sharded"])
    np.testing.assert_allclose(got["loss"], got["want_loss"], rtol=LOSS_RTOL)
    gap = np.abs(got["g_logits"] - got["w_logits"]).max() \
        / np.abs(got["w_logits"]).max()
    assert gap <= PARAM_TOL, gap
    gaps = {k: float(np.abs(got[k] - got["w:" + k[2:]]).max()
                     / max(np.abs(got["w:" + k[2:]]).max(), 1e-30))
            for k in got.files if k.startswith("p:")}
    assert gaps and max(gaps.values()) <= PARAM_TOL, gaps


@pytest.mark.parametrize("name,heads,kv,impl,split", M.ATTN,
                         ids=[c[0] for c in M.ATTN])
def test_attention_on_local_shards_equals_one_device(runs, name, heads, kv,
                                                     impl, split):
    """The attention core on the local shards of DTensor q, k, v: the
    output at the logits' 2e-4, the gradients of q, k and v at 1e-4 of
    their largest entry.  The output keeps q's layout: batch over 'data',
    heads over 'model' where they split (where q's positions split
    instead, the output gathers them back)."""
    got = _load(runs[1], f"port attention {name}")
    np.testing.assert_allclose(got["out"], got["want"], rtol=0,
                               atol=LOGIT_ATOL)
    for n in "qkv":
        gap = np.abs(got["g:" + n] - got["w:" + n]).max() \
            / np.abs(got["w:" + n]).max()
        assert gap <= PARAM_TOL, (n, gap)
    assert list(got["placements"]) == ["S(0)", split], got["placements"]


def test_constrain_redistributes_a_dtensor(runs):
    assert bool(_load(runs[1], "port constrain")["ok"])


@pytest.mark.parametrize("name", ["accum", "adafactor"])
def test_mesh_steps_equal_one_device(runs, name):
    """``n_micro=2`` and an Adafactor step (factored leaves: its row and
    column means reduce across shards) on the mesh against one device."""
    got = _load(runs[1], f"port {name}")
    np.testing.assert_allclose(got["losses"], got["want_losses"],
                               rtol=LOSS_RTOL)
    gaps = {k: float(np.abs(got[k] - got["w:" + k[2:]]).max()
                     / max(np.abs(got["w:" + k[2:]]).max(), 1e-30))
            for k in got.files if k.startswith("p:")}
    assert gaps and max(gaps.values()) <= PARAM_TOL, gaps


def test_elastic_restore_across_meshes(runs):
    got = _load(runs[1], "port elastic")
    assert bool(got["placed"]) and bool(got["same41"]) \
        and bool(got["same1"]) and bool(got["shard_only"])
    mesh_dir, one_dir = (str(d) for d in got["dirs"])
    files = sorted(os.listdir(one_dir))
    assert len(files) == int(got["n_leaves"]) + 1     # + the manifest
    assert sorted(os.listdir(mesh_dir)) == files
    match, mismatch, errors = filecmp.cmpfiles(mesh_dir, one_dir, files,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


def test_run_training_over_a_mesh(runs):
    """(2, 2) with a fault at step 3 (restored from the step-2 checkpoint
    onto the mesh) against one device without a fault."""
    from repro_torch.launch.train import run_training
    got = _load(runs[1], "port run_training")
    assert int(got["restarts"]) == 1 and int(got["final"]) == 4
    res = run_training("gemma-2b", smoke=True, steps=4, batch=M.BATCH,
                       seq=M.SEQ, ckpt_every=2, print_fn=lambda *a: None,
                       device="cpu")
    want = [m["loss"] for m in res.metrics_history]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmoe-1b-7b"])
def test_one_by_one_mesh_equals_one_device(runs, arch):
    got = _load(runs[2], f"one {arch}")
    np.testing.assert_array_equal(got["losses"], got["want_losses"])
    assert bool(got["params_equal"])
    assert float(got["logits_gap"].max()) <= LOGIT_ATOL


def test_launcher_under_torchrun_trains_over_the_mesh():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2",
         str(REPO / "tests" / "_torch_dist_mesh.py"), "launch"],
        env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    done = [line for line in out.stdout.splitlines()
            if line.startswith("done:")]
    assert len(done) == 1, out.stdout             # rank 0 alone prints
    assert "done: 3 steps, 0 restarts" in done[0]
    assert done[0].endswith("on cpu, mesh (2, 1)")
