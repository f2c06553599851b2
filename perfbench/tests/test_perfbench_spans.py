"""Device time put down to the program's spans (``perfbench/spans.py``):
``by_span`` over a hand-built trace and over a real CPU profile of a
tiny train step, each reader over a hand-built observation and over an
untraced one, and ``program_trace.py`` over the tiny cells."""
import time

import pytest
import torch

from perfbench import program_trace, spans
from perfbench import trace as ptrace

CARD = "NVIDIA H100 80GB HBM3"
MAIN, AUTOGRAD, STREAM = (1, 10), (1, 11), (0, 7)


def x(cat, name, thread, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": thread[0],
            "tid": thread[1], "ts": ts, "dur": dur, "args": args}


def span(name, thread, ts, dur):
    return x("user_annotation", "repro_torch." + name, thread, ts, dur)


def launch(thread, ts, corr):
    return x("cuda_runtime", "cudaLaunchKernel", thread, ts, 2,
             correlation=corr)


def kernel(ts, dur, corr):
    return x("kernel", f"k{corr}", STREAM, ts, dur, correlation=corr)


def flow(ph, thread, ts, fid):
    return {"ph": ph, "cat": "fwdbwd", "name": "fwdbwd", "id": fid,
            "pid": thread[0], "tid": thread[1], "ts": ts}


EVENTS = [
    # the forward: a kernel of attn.core, launched inside it
    span("train.step", MAIN, 0, 1000), span("train.grads", MAIN, 10, 890),
    span("layer", MAIN, 20, 180), span("attn.core", MAIN, 50, 100),
    x("cpu_op", "aten::mm", MAIN, 60, 20), flow("s", MAIN, 60, 7),
    launch(MAIN, 65, 1), kernel(100, 30, 1),
    # its projection on the card's timeline is not device work
    x("gpu_user_annotation", "repro_torch.attn.core", STREAM, 100, 200),
    # the backward op on autograd's thread: linked to aten::mm's span,
    # and so is the sum of gradients the engine adds after it
    x("cpu_op", "autograd::engine::evaluate_function: MmBackward0",
      AUTOGRAD, 398, 112),
    x("cpu_op", "MmBackward0", AUTOGRAD, 400, 100),
    flow("f", AUTOGRAD, 400, 7), launch(AUTOGRAD, 410, 2),
    kernel(420, 50, 2), launch(AUTOGRAD, 505, 8), kernel(492, 4, 8),
    # a replay inside the backward op keeps its own span
    span("mlp", AUTOGRAD, 430, 50), launch(AUTOGRAD, 440, 3),
    kernel(480, 10, 3),
    # the engine's own op: the span open on any thread (the step's)
    launch(AUTOGRAD, 520, 4), kernel(530, 5, 4),
    # serving: two kernels and two gaps inside serve.decode
    span("serve.decode", MAIN, 1100, 100), launch(MAIN, 1110, 5),
    kernel(1120, 20, 5), launch(MAIN, 1150, 6), kernel(1160, 10, 6),
    # a copy whose launch the trace lost
    x("gpu_memcpy", "Memcpy DtoH", STREAM, 1190, 5, correlation=99),
]


def test_by_span_on_a_hand_built_trace():
    got = spans.by_span(EVENTS)
    approx = lambda us: pytest.approx(us / 1e6)
    assert got["busy_s"] == {"attn.core": approx(84), "mlp": approx(10),
                             "train.grads": approx(5),
                             "serve.decode": approx(30),
                             spans.NONE: approx(5)}
    gaps = got["gaps_s"]
    assert gaps["attn.core"] == approx(420 - 130)
    assert gaps["mlp"] == approx(480 - 470)
    assert gaps["serve.decode"] == approx((1160 - 1140) + (1190 - 1170))
    assert got["span_s"]["serve.decode"] == approx(100)
    assert got["idle_in_s"]["serve.decode"] == approx(100 - 35)
    assert spans.coverage(got) == pytest.approx(100 * (1 - 5 / 134))


def test_by_span_without_a_flow_leaves_the_backward_to_the_step():
    cut = [e for e in EVENTS if e.get("cat") != "fwdbwd"]
    assert spans.by_span(cut)["busy_s"]["train.grads"] == \
        pytest.approx(59 / 1e6)


@pytest.mark.parametrize("arch", ["stablelm-3b", "olmoe-1b-7b"])
def test_a_cpu_profile_of_a_train_step_lands_in_the_model_spans(arch):
    """On the CPU each operator's self time stands for a kernel.  At
    least 95% of a remat step's lands in a span, and the step's own
    spans keep under 5%: the backward ops and the engine's work around
    them reach their layers' spans through the forward links, without
    which the step's spans would hold the whole backward."""
    program_trace.tracer()
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.runtime import trace
    cfg = get_config(arch, smoke=True).replace(remat=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = steps.default_optimizer(cfg)
    state = steps.TrainState(params=params, opt=opt.init(params),
                             step=torch.zeros((), dtype=torch.int32))
    step = steps.make_train_step(cfg, opt)
    toks = torch.randint(1, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(state, batch)
    finally:
        trace.disable()
        trace.drain()
    got = spans.by_span(ptrace.events_of(prof))["busy_s"]
    total = sum(got.values())
    assert spans.coverage({"busy_s": got}) >= 95.0
    assert (got.get("train.step", 0) + got.get("train.grads", 0)) \
        < 0.05 * total
    assert got["attn.core"] > 0.05 * total


def _train_obs():
    return {"kind": "train", "device_kind": CARD, "attention_flops": 1e12,
            "trace": {"spans": {"busy_s": {
                "attn.core": 0.2, "mlp": 0.1, "moe.route": 0.01,
                "moe.dispatch": 0.03, "moe.combine": 0.05},
                "span_s": {}, "idle_in_s": {}, "gaps_s": {}}},
            "program": {"profiled": [1, 2], "spans": [], "records": [],
                        "counters": {"moe.assignments": 1000,
                                     "moe.dropped": 250}}}


def _serve_obs():
    def s(i, name, parent, start, end, device_ms=None, **attrs):
        return {"id": i, "name": name, "parent": parent, "attrs": attrs,
                "thread": 1, "start_ns": start, "end_ns": end,
                "device_ms": device_ms}
    return {"kind": "serve", "device_kind": CARD,
            "trace": {"spans": {
                "busy_s": {}, "gaps_s": {},
                "span_s": {"serve.decode": 0.2, "serve.sample": 0.2},
                "idle_in_s": {"serve.decode": 0.05, "serve.sample": 0.15}}},
            "program": {
                "profiled": [1],
                "counters": {"serve.prefill_positions": 200,
                             "serve.prompt_tokens": 90},
                "spans": [s(1, "serve.wave", None, 0, 200, 150.0, wave=0),
                          s(2, "serve.prefill", 1, 5, 95, 10.0),
                          s(3, "serve.sample", 1, 100, 110),
                          s(4, "serve.decode", 1, 110, 130),
                          s(5, "serve.sample", 1, 130, 140),
                          s(6, "serve.decode", 1, 140, 160),
                          s(7, "serve.sample", 1, 160, 180),
                          s(8, "serve.wave", None, 1000, 2000, 900.0,
                            wave=1),
                          s(9, "serve.prefill", 8, 1005, 1500, 99.0),
                          s(10, "serve.decode", 8, 1500, 1800),
                          s(11, "serve.sample", 8, 1800, 1900)],
                "records": [
                    {"name": "serve.request", "uid": 0, "wave": 0,
                     "submit_ns": 10, "admit_ns": 20,
                     "first_token_ns": 110, "finish_ns": 180},
                    {"name": "serve.request", "uid": 1, "wave": 0,
                     "submit_ns": 30, "admit_ns": 40,
                     "first_token_ns": 130, "finish_ns": 180},
                    {"name": "serve.request", "uid": 2, "wave": 1,
                     "submit_ns": 500, "admit_ns": 1000,
                     "first_token_ns": 1900, "finish_ns": 1950},
                    {"name": "serve.request", "uid": 3, "wave": 0,
                     "submit_ns": None, "admit_ns": 20,
                     "first_token_ns": 110, "finish_ns": 180}]}}


READINGS = {
    "attention_ms": (_train_obs, 100.0),
    "attention_roofline": (_train_obs, 100.0 * (3e12 / 989e12) / 0.1),
    "mlp_ms": (_train_obs, 50.0),
    "moe_dispatch_ms": (_train_obs, 20.0),
    "moe_combine_ms": (_train_obs, 25.0),
    "moe_dropped": (_train_obs, 25.0),
    "prefill_ms": (_serve_obs, 10.0),
    "decode_step_ms": (_serve_obs, (30 / 1e6 + 40 / 1e6) / 2),
    "decode_idle": (_serve_obs, 50.0),
    "pad_share": (_serve_obs, 55.0),
    "ttft_s": (_serve_obs, (100 + 100) / 2 / 1e9),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_a_traced_observation(name):
    obs, want = READINGS[name]
    assert getattr(spans, name)(obs()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_finds_nothing_in_an_untraced_run(name):
    untraced = {"kind": "train", "device_kind": CARD, "attention_flops": 1,
                "trace": {"busy_s": 1.0, "window_s": 1.0, "device_ops": [],
                          "idle_gaps": [], "kernels": 3},
                "step_ms": [1.0]}
    assert getattr(spans, name)(untraced) is None
    assert getattr(spans, name)({"kind": "serve", "trace": None}) is None


@pytest.mark.parametrize("cell,want", [
    ("tiny-dense.train", {"attention_ms", "mlp_ms"}),
    ("tiny-moe.train", {"attention_ms", "moe_dispatch_ms", "moe_combine_ms",
                        "moe_dropped"}),
    ("tiny-dense.serve", {"decode_step_ms", "pad_share", "ttft_s"})])
def test_program_trace_reads_a_tiny_cell(tiny_root, cell, want):
    line = program_trace.trace_cell(tiny_root, cell, 2**31 + 17, 3.0,
                                    "cpu")
    assert line["correct"], line["checks"]
    assert want <= set(line["readings"])
    assert line["coverage"] >= 95.0
    assert line["unprofiled_ms"]


def test_program_trace_with_the_tracer_off_reads_no_span(tiny_root):
    t0 = time.perf_counter()
    line = program_trace.trace_cell(tiny_root, "tiny-dense.serve",
                                    2**31 + 17, 2.0, "cpu", on=False)
    assert line["correct"] and line["counters"] == {}
    assert line["readings"] == {} and line["unprofiled_ms"]
    assert time.perf_counter() - t0 < 120
