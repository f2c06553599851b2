"""Both sides of the (2, 2)-mesh checks in ``tests/test_torch_dist_steps.py``.

``reference`` runs the JAX package's own sharded steps on a ('data',
'model') mesh of 4 host devices built with Auto axes
(``jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ...)``);
``rank`` is one of 4 gloo ranks running the port's on a ``DeviceMesh``.
Both take params drawn by numpy (``core.convert.numpy_params``) and the
data pipeline's batches, and write one ``.npz`` a case into ``out``:

    python tests/_torch_dist_mesh.py reference OUT
    python tests/_torch_dist_mesh.py rank RANK WORLD STORE OUT   # x 4
    python tests/_torch_dist_mesh.py one OUT    # one rank: the 1x1 mesh
    torchrun --standalone --nproc-per-node 2 tests/_torch_dist_mesh.py \
        launch                                   # the launcher's CLI, CPU

The reference process needs ``JAX_PLATFORMS=cpu`` and
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before jax is
imported; ``main`` sets both.
"""
import os
import sys
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

# train cases: (name, arch, config overrides); 3 AdamW steps each
TRAIN = [("gemma-2b", "gemma-2b", {}),
         ("gemma-2b fsdp sp", "gemma-2b",
          dict(fsdp=True, seq_shard_activations=True)),
         ("olmoe-1b-7b", "olmoe-1b-7b", {}),
         ("olmoe-1b-7b scatter", "olmoe-1b-7b", {}),
         ("falcon-mamba-7b", "falcon-mamba-7b", {}),
         ("zamba2-2.7b", "zamba2-2.7b", {})]
SERVE = ["gemma-2b", "olmoe-1b-7b"]
STEPS, BATCH, SEQ, LR = 3, 4, 16, 3e-4
# (batch, seq) of the cases that do not train on BATCH x SEQ: 2 x 8 tokens
# are fewer than the all-to-all's 16 a 'model' rank, so the MoE layers take
# the scatter path on the mesh, with its gradients
SHAPES = {"olmoe-1b-7b scatter": (2, 8)}
# the attention core on local shards: (name, heads, kv heads, impl, the
# output's placements); on the (2, 2) mesh MHA and GQA split k, v by KV
# head over 'model', MQA splits q by group, and 3 heads, which 2 ranks do
# not split, split q's positions instead (the output then replicates)
ATTN = [("mha", 4, 4, "dense", "S(2)"),
        ("gqa", 4, 2, "flash_jnp", "S(2)"),
        ("mqa", 4, 1, "dense", "S(2)"),
        ("mqa flash", 4, 1, "flash_jnp", "S(2)"),
        ("positions", 3, 3, "dense", "R"),
        ("positions flash", 3, 3, "flash_jnp", "R")]
MAX_LEN, DECODE = 32, 3
A2A_ARCH = "olmoe-1b-7b"


def batches(cfg, n=STEPS, name=None):
    from repro_torch.data import make_dataset
    batch, seq = SHAPES.get(name, (BATCH, SEQ))
    ds = make_dataset(cfg, seq_len=seq, global_batch=batch, seed=1)
    return [ds.batch_at(s) for s in range(n)]


def decode_tokens(cfg):
    """The serve cases' prompt and the tokens fed at each decode step:
    fixed, so neither side's argmax picks them."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab, (DECODE, BATCH, 1)).astype(np.int32)
    return prompt, steps


def a2a_inputs(cfg):
    """One MoE layer's params, its input and the output's cotangent."""
    rng = np.random.default_rng(7)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "w_gate": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_up": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_down": rng.normal(size=(e, f, d)) * f ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(BATCH, SEQ, d)).astype(np.float32)
    r = rng.normal(size=(BATCH, SEQ, d)).astype(np.float32)
    return p, x, r


def _save(dest, name, **arrays):
    np.savez(os.path.join(dest, name.replace(" ", "_") + ".npz"), **arrays)


def _params_arrays(named):
    return {f"p:{k}": np.asarray(v, np.float32) for k, v in named.items()}


# --------------------------------------------------------------------------
# the reference: its own sharded steps on 4 host devices
# --------------------------------------------------------------------------

def reference(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.models.moe as jmoe
    from repro.configs import get_config
    from repro.launch.steps import (TrainState, jit_prefill_step,
                                    jit_serve_step, jit_train_step)
    from repro.models import init_cache
    from repro.optim import adamw
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core.convert import numpy_params
    from repro_torch.tree import named_leaves

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    calls = [0]
    a2a = jmoe._moe_block_a2a

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)

    jmoe._moe_block_a2a = counted

    def named(tree):
        return {n: np.asarray(jnp.asarray(x, jnp.float32))
                for n, x in named_leaves(jax.tree.map(np.asarray, tree))}

    for name, arch, over in TRAIN:
        cfg = get_config(arch, smoke=True).replace(**over)
        params = jax.tree.map(jnp.asarray,
                              numpy_params(t_get_config(arch, smoke=True), 0))
        data = [{k: jnp.asarray(v) for k, v in b.items()}
                for b in batches(cfg, name=name)]
        bspec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                 for k, v in data[0].items()}
        opt = adamw(LR)
        fn, _, _ = jit_train_step(cfg, opt, mesh, bspec)
        state = TrainState(params, opt.init(params), jnp.zeros((), jnp.int32))
        calls[0] = 0
        losses, auxes = [], []
        for b in data:
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux_loss"]))
        _save(out, f"ref {name}", losses=np.array(losses),
              aux=np.array(auxes), a2a=np.array(calls[0]),
              **_params_arrays(named(state.params)))

    for arch in SERVE:
        cfg = get_config(arch, smoke=True)
        params = jax.tree.map(jnp.asarray,
                              numpy_params(t_get_config(arch, smoke=True), 0))
        prompt, steps = decode_tokens(cfg)
        bspec = {"tokens": jax.ShapeDtypeStruct(prompt.shape, jnp.int32)}
        pf, _, _ = jit_prefill_step(cfg, mesh, bspec, BATCH, MAX_LEN)
        sv, _, _ = jit_serve_step(cfg, mesh, BATCH, MAX_LEN)
        calls[0] = 0
        logits, cache = pf(params, {"tokens": jnp.asarray(prompt)},
                           init_cache(cfg, BATCH, MAX_LEN))
        outs = [np.asarray(logits)]
        for tok in steps:
            logits, cache = sv(params, jnp.asarray(tok), cache)
            outs.append(np.asarray(logits))
        _save(out, f"ref serve {arch}", logits=np.stack(outs),
              a2a=np.array(calls[0]))

    cfg = get_config(A2A_ARCH, smoke=True)
    p, x, r = a2a_inputs(cfg)

    def loss(p, x):
        o, aux = a2a(p, x, cfg, mesh, ("data",), "model", 2)
        return jnp.sum(o * r) + 3.0 * aux, (o, aux)

    (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    _save(out, "ref a2a", y=np.asarray(o), aux=np.asarray(aux),
          gx=np.asarray(gx), **{f"g:{k}": np.asarray(v)
                                for k, v in gp.items()})


# --------------------------------------------------------------------------
# the port: one gloo rank of 4
# --------------------------------------------------------------------------

def _port_common():
    """Count the MoE block's mesh paths: calls[0] the all-to-all's,
    calls[1] the scatter path's on DTensors."""
    import torch

    import repro_torch.models.moe as tmoe
    calls = [0, 0]
    a2a, scatter = tmoe._moe_block_a2a, tmoe._moe_block_mesh

    def counted(*a, **k):
        calls[0] += 1
        return a2a(*a, **k)

    def counted_scatter(*a, **k):
        calls[1] += 1
        return scatter(*a, **k)

    tmoe._moe_block_a2a = counted
    tmoe._moe_block_mesh = counted_scatter
    torch.set_num_threads(1)
    return calls, a2a


def _port_train(cfg, fn_builder, opt, n_steps=STEPS, name=None):
    """(losses, auxes, state) of ``n_steps`` of the step ``fn_builder``
    gives on the pipeline's batches."""
    import torch

    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.launch.steps import TrainState

    params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
    data = [{k: torch.as_tensor(v) for k, v in b.items()}
            for b in batches(cfg, n_steps, name)]
    fn = fn_builder(data[0])
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    losses, auxes = [], []
    for b in data:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
        auxes.append(float(m.get("aux_loss", 0.0)))
    return losses, auxes, state


def _whole_named(tree):
    from repro_torch.dist import gather_tree
    from repro_torch.tree import named_leaves
    return {n: x.detach().float().numpy()
            for n, x in named_leaves(gather_tree(tree))}


def rank(rank_, world, store, out):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank_, world_size=world)
    calls, a2a = _port_common()
    try:
        _rank_cases(rank_, out, calls, a2a)
    except Exception:
        with open(os.path.join(out, f"error_rank{rank_}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _rank_cases(rank_, out, calls, a2a):
    import tempfile

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.checkpoint import CheckpointManager, save_state
    from repro_torch.checkpoint.checkpoint import restore_state
    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.dist import axis_rules, constrain, gather_tree, make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (jit_prefill_step,
                                          jit_serve_step, jit_train_step,
                                          make_grad_accum_train_step,
                                          make_train_step, state_specs,
                                          train_shardings)
    from repro_torch.launch.train import run_training
    from repro_torch.models import init_cache
    from repro_torch.optim import adafactor, adamw
    from repro_torch.tree import named_leaves

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    zero = rank_ == 0

    def save(name, **arrays):
        if zero:
            _save(out, name, **arrays)

    # ---- constrain on a DTensor ------------------------------------------
    rules = make_rules(mesh)
    x = DTensor.from_local(torch.ones(2, 8), mesh, [Replicate(), Replicate()])
    with axis_rules(mesh, rules):
        y = constrain(x, ("batch", "ff"))
    save("port constrain", ok=np.array(
        list(y.placements) == [Shard(0), Shard(1)]
        and bool((y.full_tensor() == 1).all())))

    # ---- the vocab-parallel loss against the plain one ----------------------
    _vocab_loss_case(mesh, rules, save)

    # ---- the attention core on local shards against one device -------------
    _attention_cases(mesh, rules, save)

    # ---- 3 AdamW steps a train case --------------------------------------
    kept = {}
    for name, arch, over in TRAIN:
        # the JAX package has no Falcon-Mamba mixer norms
        cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None, **over)
        opt = adamw(LR)
        calls[:] = [0, 0]
        losses, auxes, state = _port_train(
            cfg, lambda b: jit_train_step(cfg, opt, mesh, b)[0], opt,
            name=name)
        named = _whole_named(state.params)
        save(f"port {name}", losses=np.array(losses), aux=np.array(auxes),
             a2a=np.array(calls[0]), scatter=np.array(calls[1]),
             **_params_arrays(named))
        if name == "gemma-2b fsdp sp":
            kept["state"], kept["cfg"], kept["opt"] = state, cfg, opt

    # ---- prefill + 3 decode steps ------------------------------------------
    for arch in SERVE:
        cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
        params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
        prompt, steps = decode_tokens(cfg)
        batch = {"tokens": torch.as_tensor(prompt)}
        pf, _, _ = jit_prefill_step(cfg, mesh, batch, BATCH, MAX_LEN)
        sv, _, _ = jit_serve_step(cfg, mesh, BATCH, MAX_LEN)
        calls[:] = [0, 0]
        logits, cache = pf(params, batch, init_cache(cfg, BATCH, MAX_LEN,
                                                     "cpu"))
        outs = [logits.full_tensor()]
        for tok in steps:
            logits, cache = sv(params, torch.as_tensor(tok), cache)
            outs.append(logits.full_tensor())
        save(f"port serve {arch}", logits=torch.stack(outs).numpy(),
             a2a=np.array(calls[0]), scatter=np.array(calls[1]))

    # ---- the a2a block alone, with its gradients ---------------------------
    cfg = get_config(A2A_ARCH, smoke=True)
    p, xn, r = a2a_inputs(cfg)
    w_pl, rep = [Replicate(), Shard(0)], [Replicate(), Replicate()]
    dp = {k: DTensor.from_local(torch.as_tensor(v), mesh, rep).redistribute(
        mesh, rep if k == "router" else w_pl).requires_grad_(True)
        for k, v in p.items()}
    dx = DTensor.from_local(torch.as_tensor(xn), mesh, rep).redistribute(
        mesh, [Shard(0), Replicate()]).requires_grad_(True)
    with axis_rules(mesh, rules), implicit_replication():
        o, aux = a2a(dp, dx, cfg, mesh, ("data",), "model", 2)
        total = torch.sum(o * torch.as_tensor(r)) + 3.0 * aux
        grads = torch.autograd.grad(total, [dp[k] for k in sorted(dp)]
                                    + [dx])
    whole = [g.full_tensor().numpy() for g in grads]
    save("port a2a", y=o.full_tensor().detach().numpy(),
         aux=aux.full_tensor().detach().numpy(), gx=whole[-1],
         **{f"g:{k}": g for k, g in zip(sorted(dp), whole)})

    # ---- n_micro = 2 and Adafactor on the mesh, against one device ----------
    cfg = get_config("gemma-2b", smoke=True).replace(fsdp=True)
    for name, opt, n_micro in (("accum", adamw(LR), 2),
                               ("adafactor", adafactor(
                                   1e-2, min_dim_factored=4), 1)):
        got = _port_train(cfg, lambda b: jit_train_step(
            cfg, opt, mesh, b, n_micro=n_micro)[0], opt, 2)
        want = _port_train(cfg, lambda b: (
            make_train_step(cfg, opt) if n_micro == 1
            else make_grad_accum_train_step(cfg, opt, n_micro)), opt, 2)
        save(f"port {name}", losses=np.array(got[0]),
             want_losses=np.array(want[0]),
             **_params_arrays(_whole_named(got[2].params)),
             **{f"w:{k}": v for k, v in _whole_named(want[2].params).items()})

    # ---- elastic restore: written on (2,2), read onto (4,1) and one device --
    state, cfg, opt = kept["state"], kept["cfg"], kept["opt"]
    box = [tempfile.mkdtemp(dir=out) if zero else None]
    torch.distributed.broadcast_object_list(box, src=0)
    d_mesh, d_one = os.path.join(box[0], "mesh"), os.path.join(box[0], "one")
    mgr = CheckpointManager(d_mesh, keep=2)
    mgr.save(STEPS, state)
    mgr.wait()
    whole = gather_tree(state)
    if zero:
        save_state(d_one, STEPS, whole)
    torch.distributed.barrier()
    mesh41 = make_mesh((4, 1), ("data", "model"), "cpu")
    sh41, _ = train_shardings(cfg, opt, mesh41)
    abstract = state_specs(cfg, opt)
    on41 = restore_state(d_mesh, STEPS, abstract, "cpu", shardings=sh41)
    placed = all(tuple(x.placements) == tuple(s.placements)
                 for (_, x), (_, s) in zip(named_leaves(on41),
                                           named_leaves(sh41)))
    # each rank's storage holds its shard alone, and some leaves are split
    locals_ = [(x.to_local(), x) for _, x in named_leaves(on41)]
    shard_only = all(loc.untyped_storage().nbytes()
                     == loc.numel() * loc.element_size()
                     for loc, _ in locals_) \
        and any(loc.numel() < x.numel() for loc, x in locals_)
    one = restore_state(d_mesh, STEPS, abstract, "cpu")
    same41 = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        named_leaves(gather_tree(on41)), named_leaves(whole)))
    same1 = all(torch.equal(a, b) and not hasattr(a, "placements")
                for (_, a), (_, b) in zip(named_leaves(one),
                                          named_leaves(whole)))
    save("port elastic", placed=np.array(placed), same41=np.array(same41),
         shard_only=np.array(shard_only),
         same1=np.array(same1), n_leaves=np.array(len(named_leaves(whole))),
         dirs=np.array([os.path.join(d_mesh, f"step_{STEPS}"),
                        os.path.join(d_one, f"step_{STEPS}")]))

    # ---- run_training over the mesh, a fault at step 3, against one device --
    kw = dict(smoke=True, steps=4, batch=BATCH, seq=SEQ, ckpt_every=2,
              print_fn=lambda *a: None, device="cpu")
    res = run_training("gemma-2b", mesh_shape=(2, 2), fail_at=(3,), **kw)
    got = [m["loss"] for m in res.metrics_history]
    save("port run_training", losses=np.array(got),
         restarts=np.array(res.restarts), final=np.array(res.final_step))


def _attention_cases(mesh, rules, save):
    """``multihead_attention`` on DTensor q, k, v (laid out otherwise than
    the core wants: batch over 'data' for q, the KV sequence over 'model'
    for k and v) against the same call on the whole tensors: the output,
    and the gradients of q, k and v under a fixed cotangent.  Causal, with
    a KV length mask that hides the last two positions; the flash twin in
    blocks of 3 keys (its KV padding on the local shards)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import axis_rules
    from repro_torch.models.attention import multihead_attention

    rep = [Replicate(), Replicate()]
    layouts = ([Shard(0), Replicate()], [Replicate(), Shard(1)],
               [Replicate(), Shard(1)])
    for i, (name, h, nkv, impl, _) in enumerate(ATTN):
        rng = np.random.default_rng(20 + i)
        arrays = [rng.normal(size=(BATCH, 8, n, 8)).astype(np.float32)
                  for n in (h, nkv, nkv)]
        r = torch.as_tensor(rng.normal(size=(BATCH, 8, h, 8)),
                            dtype=torch.float32)
        kw = dict(causal=True, q_positions=torch.arange(8),
                  kv_len_mask=(torch.arange(8) < 6).expand(BATCH, 8),
                  impl=impl, block_kv=3)
        whole = [torch.as_tensor(a).requires_grad_(True) for a in arrays]
        want = multihead_attention(*whole, **kw)
        want_grads = torch.autograd.grad((want * r).sum(), whole)
        dts = [DTensor.from_local(torch.as_tensor(a), mesh, rep).redistribute(
            mesh, pl).requires_grad_(True) for a, pl in zip(arrays, layouts)]
        with axis_rules(mesh, rules), implicit_replication():
            out = multihead_attention(*dts, **kw)
            grads = torch.autograd.grad((out * r).sum(), dts)
        save(f"port attention {name}",
             out=out.full_tensor().detach().numpy(),
             want=want.detach().numpy(),
             placements=np.array([str(p) for p in out.placements]),
             **{f"g:{n}": g.full_tensor().numpy()
                for n, g in zip("qkv", grads)},
             **{f"w:{n}": g.numpy() for n, g in zip("qkv", want_grads)})


def _vocab_loss_case(mesh, rules, save):
    """``token_nll`` on logits sharded (batch over 'data', vocab over
    'model'), its mean's gradient on the logits, and ``loss_fn``'s value
    and param gradients on the mesh (gemma-2b smoke: tied embeddings, the
    vocab over 'model'), each beside the same on the plain whole tensors."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.dist import axis_rules, distribute_tree, gather_tree
    from repro_torch.launch.steps import train_shardings
    from repro_torch.models import loss_fn
    from repro_torch.models.model import token_nll
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, named_leaves, unflatten

    rng = np.random.default_rng(11)
    lg = rng.normal(size=(BATCH, SEQ, 64)).astype(np.float32) * 3
    lg[..., 60:] = -1e30                     # padded ids, as ``_logits``
    labels = rng.integers(0, 60, (BATCH, SEQ))
    rep = [Replicate(), Replicate()]
    whole = torch.as_tensor(lg).requires_grad_(True)
    want = token_nll(whole, torch.as_tensor(labels)).mean()
    want.backward()
    dlg = DTensor.from_local(torch.as_tensor(lg), mesh, rep).redistribute(
        mesh, [Shard(0), Shard(2)]).detach().requires_grad_(True)
    dlab = DTensor.from_local(torch.as_tensor(labels), mesh, rep
                              ).redistribute(mesh, [Shard(0), Replicate()])
    got = token_nll(dlg, dlab).mean()
    got.backward()

    cfg = get_config("gemma-2b", smoke=True)
    opt = adamw(LR)
    batch = {k: torch.as_tensor(v) for k, v in batches(cfg, 1)[0].items()}
    params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
    for x in leaves(params):
        x.requires_grad_(True)
    want_total, _ = loss_fn(cfg, params, batch)
    want_grads = torch.autograd.grad(want_total, leaves(params))
    state_sh, bshard = train_shardings(cfg, opt, mesh, rules)
    dparams = distribute_tree(
        unflatten(params, [x.detach() for x in leaves(params)]),
        state_sh.params)
    for x in leaves(dparams):
        x.requires_grad_(True)
    dbatch = {k: DTensor.from_local(v, mesh, rep).redistribute(
        mesh, bshard(v).placements) for k, v in batch.items()}
    with axis_rules(mesh, rules), implicit_replication():
        total, _ = loss_fn(cfg, dparams, dbatch)
        grads = torch.autograd.grad(total, leaves(dparams))
    got_grads = gather_tree(unflatten(dparams, list(grads)))
    save("port vocab loss", loss=np.array([float(got.full_tensor()),
                                           float(total.full_tensor())]),
         want_loss=np.array([float(want), float(want_total)]),
         g_logits=dlg.grad.full_tensor().numpy(),
         w_logits=whole.grad.numpy(),
         vocab_sharded=np.array(
             list(dparams["embed"].placements) == [Replicate(), Shard(0)]),
         **{f"p:{n}": x.numpy() for n, x in named_leaves(got_grads)},
         **{f"w:{n}": x.numpy() for n, x in named_leaves(
             unflatten(params, list(want_grads)))})


def one(out):
    """One gloo rank: the 1x1 mesh's sharded steps against the one-device
    steps for two archs (train steps bit for bit, logits' largest gap)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.convert import numpy_params, params_from_numpy
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (jit_prefill_step, jit_serve_step,
                                          jit_train_step, make_train_step)
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.optim import adamw

    store = os.path.join(tempfile.mkdtemp(dir=out), "store")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    torch.set_num_threads(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        for arch in ("gemma-2b", "olmoe-1b-7b"):
            cfg = get_config(arch, smoke=True).replace(fsdp=True)
            opt = adamw(LR)
            got = _port_train(cfg, lambda b: jit_train_step(
                cfg, opt, mesh, b)[0], opt)
            want = _port_train(cfg, lambda b: make_train_step(cfg, opt), opt)
            params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
            prompt, steps = decode_tokens(cfg)
            batch = {"tokens": torch.as_tensor(prompt)}
            pf, _, _ = jit_prefill_step(cfg, mesh, batch, BATCH, MAX_LEN)
            sv, _, _ = jit_serve_step(cfg, mesh, BATCH, MAX_LEN)
            lg, cache = pf(params, batch, init_cache(cfg, BATCH, MAX_LEN,
                                                     "cpu"))
            l1, c1 = prefill(cfg, params, batch,
                             init_cache(cfg, BATCH, MAX_LEN, "cpu"))
            pairs = [(lg.full_tensor(), l1)]
            for tok in steps:
                lg, cache = sv(params, torch.as_tensor(tok), cache)
                l1, c1 = decode_step(cfg, params, torch.as_tensor(tok), c1)
                pairs.append((lg.full_tensor(), l1))
            _save(out, f"one {arch}",
                  losses=np.array(got[0]), want_losses=np.array(want[0]),
                  params_equal=np.array(all(
                      np.array_equal(a, b) for a, b in zip(
                          _whole_named(got[2].params).values(),
                          _whole_named(want[2].params).values()))),
                  logits_gap=np.array([float((a - b).abs().max())
                                       for a, b in pairs]))
    finally:
        dist.destroy_process_group()


def launch():
    """``launch.train.main`` as ``torchrun`` starts it, one process a rank,
    on the CPU (gloo): a (2, 1) mesh from ``--dp 2``."""
    import torch

    from repro_torch.launch.train import main as train_main
    torch.set_num_threads(1)
    train_main(["--arch", "gemma-2b", "--smoke", "--steps", "3",
                "--batch", str(BATCH), "--seq", str(SEQ), "--dp", "2",
                "--tp", "1"], device="cpu")


def main(argv):
    if argv[0] == "launch":
        launch()
    elif argv[0] == "reference":
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = \
            "--xla_force_host_platform_device_count=4"
        reference(argv[1])
    elif argv[0] == "rank":
        rank(int(argv[1]), int(argv[2]), argv[3], argv[4])
    elif argv[0] == "one":
        one(argv[1])
    else:
        raise SystemExit(f"unknown side {argv[0]!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
