"""The port's tracer (``repro_torch.runtime.trace``) on the CPU: off, it
changes no output and calls neither ``record_function`` nor a CUDA event;
on, the spans of a train step and a serving wave nest as the layers do,
the MoE's dropped-slot counter and the serving padding counters equal
independent counts, each request's times are in order, and the remat
replay's spans belong to the thread that replays them."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import init_params, loss_fn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCHS = {"dense": "stablelm-3b", "moe": "olmoe-1b-7b"}
ATTN = ["attn.qkv", "attn.core", "attn.out"]
CHILDREN = {"dense": ATTN + ["mlp"],
            "moe": ATTN + ["moe.route", "moe.dispatch", "moe.experts",
                           "moe.combine"]}


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _cfg(kind, **over):
    return get_config(ARCHS[kind], smoke=True).replace(**over)


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _batch(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(1, cfg.vocab, (b, s + 1), generator=g)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _train(cfg, n_steps=2):
    """Losses and final parameters of ``n_steps`` default train steps."""
    params = _params(cfg)
    opt = steps.default_optimizer(cfg)
    state = steps.TrainState(params=params, opt=opt.init(params),
                             step=torch.zeros((), dtype=torch.int32))
    step = steps.make_train_step(cfg, opt)
    losses = []
    for j in range(n_steps):
        state, metrics = step(state, _batch(cfg, seed=j))
        losses.append(metrics["loss"])
    return torch.stack(losses), state.params


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


LENGTHS = [3, 9, 5, 12, 7]


def _serve(cfg, lengths=LENGTHS, max_batch=3):
    eng = ServeEngine(cfg, _params(cfg), max_batch=max_batch, max_len=32)
    for i, p in enumerate(_prompts(cfg.vocab, lengths)):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    return {r.uid: r.tokens for r in eng.run_all()}


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_tracing_changes_no_output(kind):
    cfg = _cfg(kind, remat=True)
    off_loss, off_params = _train(cfg)
    off_tokens = _serve(cfg)
    trace.enable()
    on_loss, on_params = _train(cfg)
    on_tokens = _serve(cfg)
    trace.disable()
    assert trace.drain()["spans"]
    assert torch.equal(off_loss, on_loss)
    for a, b in zip(leaves(off_params), leaves(on_params)):
        assert torch.equal(a, b)
    assert off_tokens.keys() == on_tokens.keys()
    for uid in off_tokens:
        np.testing.assert_array_equal(off_tokens[uid], on_tokens[uid])


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_off_calls_no_record_function_and_no_event(kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    cfg = _cfg(kind, remat=True)
    _train(cfg, n_steps=1)
    _serve(cfg)
    # off, every span is the one shared null context
    assert trace.span("a") is trace.span("b", device=True, attrs={"i": 1})
    monkeypatch.undo()
    assert trace.drain() == {"spans": [], "counters": {}, "records": []}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_train_step_span_tree(kind):
    cfg = _cfg(kind)
    trace.enable()
    _train(cfg, n_steps=1)
    spans = trace.drain()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["train.step"]
    assert roots[0]["device_ms"] is None          # no card: no events
    top = _children(spans, roots[0])
    assert [s["name"] for s in top] == ["train.grads", "optim.update"]
    grads = _children(spans, top[0])
    assert [s["name"] for s in grads] == (
        ["model.embed"] + ["layer"] * cfg.n_layers
        + ["model.head", "model.head"])
    layers = [s for s in grads if s["name"] == "layer"]
    assert [s["attrs"]["i"] for s in layers] == list(range(cfg.n_layers))
    for layer in layers:
        kids = sorted(_children(spans, layer), key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == CHILDREN[kind]
        core = kids[1]
        assert core["attrs"] == {"impl": "dense", "sq": 16, "skv": 16}
        for s in kids:
            assert layer["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= layer["end_ns"]
            assert s["thread"] == layer["thread"]


def test_moe_dropped_equals_an_independent_count():
    """A router that sends every token to the same experts overflows
    them; the counter equals the assignments past each expert's
    capacity, counted from the routing alone."""
    cfg = _cfg("moe", capacity_factor=1.0)
    params = _params(cfg)
    layer = {k: v[0] for k, v in params["stack"]["layers"]["moe"].items()}
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 24, cfg.d_model), generator=g) + 0.5
    router = torch.zeros_like(layer["router"])
    router[:, 0] = 1.0
    router[:, 1] = 0.5
    router[:, 2:] = 0.01 * torch.randn(router[:, 2:].shape, generator=g)
    layer["router"] = router
    trace.enable()
    out, _ = moe.moe_block(layer, x, cfg)
    counters = trace.drain()["counters"]
    xt = x.reshape(-1, cfg.d_model)
    _, experts, _ = moe.route_topk(router, xt, cfg)
    per_expert = torch.bincount(experts.reshape(-1),
                                minlength=cfg.n_experts)
    cap = moe._capacity(cfg, xt.shape[0])
    dropped = int(torch.clamp(per_expert - cap, min=0).sum())
    assert dropped > 0
    assert counters == {"moe.assignments": xt.shape[0] * cfg.top_k,
                        "moe.dropped": dropped}
    trace.disable()
    torch.testing.assert_close(moe.moe_block(layer, x, cfg)[0], out,
                               rtol=0, atol=0)


def test_serving_spans_counters_and_request_times():
    cfg = _cfg("dense")
    trace.enable()
    _serve(cfg)
    got = trace.drain()
    waves = [LENGTHS[:3], LENGTHS[3:]]
    assert got["counters"] == {
        "serve.prefill_positions": sum(len(w) * max(w) for w in waves),
        "serve.prompt_tokens": sum(LENGTHS)}
    spans = got["spans"]
    roots = sorted((s for s in spans if s["parent"] is None),
                   key=lambda s: s["start_ns"])
    assert [r["name"] for r in roots] == ["serve.wave"] * 2
    for n, (root, w) in enumerate(zip(roots, waves)):
        assert root["attrs"] == {"wave": n, "B": len(w), "plen": max(w),
                                 "max_new": 4}
        kids = sorted(_children(spans, root), key=lambda s: s["start_ns"])
        assert [s["name"] for s in kids] == (
            ["serve.admit", "serve.prefill"]
            + ["serve.sample", "serve.decode"] * 3 + ["serve.sample"])
    recs = sorted(got["records"], key=lambda r: r["uid"])
    assert [r["uid"] for r in recs] == list(range(len(LENGTHS)))
    assert [r["wave"] for r in recs] == [0, 0, 0, 1, 1]
    for r in recs:
        assert r["name"] == "serve.request"
        assert r["submit_ns"] <= r["admit_ns"] <= r["first_token_ns"] \
            <= r["finish_ns"]


def test_pad_counters_equal_padded_minus_real_positions():
    cfg = _cfg("dense")
    lengths = [11, 2, 2, 6, 13, 1, 4]
    trace.enable()
    _serve(cfg, lengths, max_batch=4)
    c = trace.drain()["counters"]
    padded = 4 * 11 + 3 * 13          # waves [11, 2, 2, 6] and [13, 1, 4]
    assert c["serve.prefill_positions"] - c["serve.prompt_tokens"] == \
        padded - sum(lengths)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_remat_replay_spans_belong_to_the_replaying_thread(kind):
    """The backward runs on another thread (as autograd's device thread
    does on a card): each layer's replay opens its spans there, nested
    under that thread's own spans and not under the forward's."""
    cfg = _cfg(kind, remat=True)
    params = _params(cfg)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    trace.enable()
    with trace.span("forward"):
        total, _ = loss_fn(cfg, params, _batch(cfg))
    out = {}

    def backward():
        with trace.span("backward"):
            out["grads"] = torch.autograd.grad(total, flat)
        out["thread"] = threading.get_native_id()

    worker = threading.Thread(target=backward)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and "grads" in out
    spans = trace.drain()["spans"]
    by_id = _by_id(spans)
    layers = [s for s in spans if s["name"] == "layer"]
    main = threading.get_native_id()
    first = [s for s in layers if s["thread"] == main]
    replay = [s for s in layers if s["thread"] == out["thread"]]
    assert len(first) == len(replay) == cfg.n_layers
    assert sorted(s["attrs"]["i"] for s in replay) == \
        list(range(cfg.n_layers))
    for s in replay:
        assert by_id[s["parent"]]["name"] == "backward"
        kids = _children(spans, s)
        assert "attn.core" in [k["name"] for k in kids]
        assert {k["name"] for k in kids} <= set(CHILDREN[kind])
        assert all(k["thread"] == out["thread"] for k in kids)
    for s in first:
        assert by_id[s["parent"]]["name"] == "forward"


def test_counters_sum_ints_and_tensors_and_drain_clears():
    trace.enable()
    trace.count("a", 2)
    trace.count("a", torch.tensor(5))
    trace.count("b", torch.tensor(1))
    trace.record("r", x=1)
    with trace.span("s", attrs={"k": 1}):
        trace.annotate(m=2)
    got = trace.drain()
    assert got["counters"] == {"a": 7, "b": 1}
    assert got["records"] == [{"name": "r", "x": 1}]
    [s] = got["spans"]
    assert (s["name"], s["attrs"], s["parent"]) == ("s", {"k": 1, "m": 2},
                                                    None)
    assert trace.drain() == {"spans": [], "counters": {}, "records": []}
