"""The port's token-serving engine and launcher against the JAX package's
(smoke configs, float32, CPU): greedy ServeEngine tokens equal the
reference's with the reference's params converted, wave by wave; the three
tests/test_serving_and_data.py engine checks on the port; sampled requests
(the port's torch.Generator cannot replay jax.random) checked for their
lengths, early stops and waves; ``launch.serve.run_serving`` on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402


def _port_params(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _prompts(vocab, n, seed, lo=3, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b",
                                  "olmoe-1b-7b", "whisper-base"])
def test_greedy_tokens_equal_reference(arch):
    """Five greedy requests of 3–9 prompt tokens, max_batch 3 (two waves,
    left-padded), the reference's params on both sides."""
    j_cfg = j_get_config(arch, smoke=True)
    j_params = j_init_params(j_cfg, jax.random.PRNGKey(0))
    # the JAX package has no Falcon-Mamba mixer norms
    cfg = get_config(arch, smoke=True).replace(mixer_rms_eps=None)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, j_params),
                               "cpu")
    prompts = _prompts(cfg.vocab, 5, seed=0)
    j_eng = JEngine(j_cfg, j_params, max_batch=3, max_len=48)
    t_eng = ServeEngine(cfg, params, max_batch=3, max_len=48)
    for i, p in enumerate(prompts):
        j_eng.submit(JRequest(uid=i, prompt=p, max_new_tokens=6))
        t_eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    want = {r.uid: r for r in j_eng.run_all()}
    got = {r.uid: r for r in t_eng.run_all()}
    assert sorted(got) == sorted(want)
    for uid, r in got.items():
        np.testing.assert_array_equal(r.tokens, want[uid].tokens)
        assert (r.prompt_len, r.steps, r.error) == \
            (want[uid].prompt_len, want[uid].steps, want[uid].error)


def test_serve_engine_waves_and_greedy_determinism():
    """tests/test_serving_and_data.py's check on the port."""
    cfg = get_config("gemma-2b", smoke=True)
    params = _port_params(cfg)
    engine = ServeEngine(cfg, params, max_batch=3, max_len=96)
    prompts = _prompts(cfg.vocab, 5, seed=0)
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    results = engine.run_all()
    assert len(results) == 5
    assert all(len(r.tokens) == 6 for r in results)

    e2 = ServeEngine(cfg, params, max_batch=2, max_len=96)
    e2.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=6))
    e2.submit(Request(uid=1, prompt=prompts[0], max_new_tokens=6))
    r = e2.run_all()
    np.testing.assert_array_equal(r[0].tokens, r[1].tokens)


def test_serve_engine_length_aware_wave_packing():
    """tests/test_serving_and_data.py's check on the port: an unfittable
    request gets an error Result, neighbours are unharmed, and requests
    that fit alone but not together split across waves."""
    cfg = get_config("gemma-2b", smoke=True)
    params = _port_params(cfg)
    rng = np.random.default_rng(1)

    engine = ServeEngine(cfg, params, max_batch=4, max_len=32)
    ok_prompt = rng.integers(1, cfg.vocab, 4).astype(np.int32)
    big_prompt = rng.integers(1, cfg.vocab, 30).astype(np.int32)
    engine.submit(Request(uid=0, prompt=ok_prompt, max_new_tokens=4))
    engine.submit(Request(uid=1, prompt=big_prompt, max_new_tokens=8))
    engine.submit(Request(uid=2, prompt=ok_prompt, max_new_tokens=4))
    results = {r.uid: r for r in engine.run_all()}
    assert results[1].error is not None and "max_len" in results[1].error
    assert len(results[1].tokens) == 0
    for uid in (0, 2):
        assert results[uid].error is None
        assert len(results[uid].tokens) == 4

    e2 = ServeEngine(cfg, params, max_batch=4, max_len=32)
    e2.submit(Request(uid=0, prompt=rng.integers(1, cfg.vocab, 24)
                      .astype(np.int32), max_new_tokens=8))
    e2.submit(Request(uid=1, prompt=rng.integers(1, cfg.vocab, 4)
                      .astype(np.int32), max_new_tokens=20))
    first = e2.run_wave()
    assert [r.uid for r in first] == [0] and e2.queue
    second = e2.run_wave()
    assert [r.uid for r in second] == [1]
    assert all(r.error is None for r in first + second)


def test_serve_engine_eos_early_stop():
    """tests/test_serving_and_data.py's check on the port."""
    cfg = get_config("gemma-2b", smoke=True)
    params = _port_params(cfg)
    engine = ServeEngine(cfg, params, max_batch=1, max_len=64)
    engine.submit(Request(uid=0, prompt=np.asarray([5, 6], np.int32),
                          max_new_tokens=8))
    greedy_first = engine.run_all()[0].tokens[0]
    engine.submit(Request(uid=1, prompt=np.asarray([5, 6], np.int32),
                          max_new_tokens=8, eos_id=int(greedy_first)))
    r = engine.run_all()[0]
    assert len(r.tokens) == 1 and r.tokens[0] == greedy_first


def _sampled_run(seed):
    cfg = get_config("olmoe-1b-7b", smoke=True)
    engine = ServeEngine(cfg, _port_params(cfg), max_batch=2, max_len=40,
                         seed=seed)
    for i, p in enumerate(_prompts(cfg.vocab, 5, seed=4)):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=3 + i,
                              temperature=0.0 if i == 2 else 0.8))
    return engine.run_all()


def test_sampled_requests_lengths_waves_and_seed():
    """Temperature 0.8 beside a greedy slot: each request returns its own
    max_new_tokens, in waves of two (steps = the wave's longest), every
    token a real vocabulary id; the same seed replays the same tokens and
    another seed draws others."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    a, b, c = _sampled_run(0), _sampled_run(0), _sampled_run(1)
    assert [r.uid for r in a] == [0, 1, 2, 3, 4]
    assert [len(r.tokens) for r in a] == [3, 4, 5, 6, 7]
    assert [r.steps for r in a] == [4, 4, 6, 6, 7]
    for r in a:
        assert ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))
    np.testing.assert_array_equal(a[2].tokens, c[2].tokens)  # greedy slot


def test_sampled_eos_stops_early():
    """A sampled request whose eos is its first drawn token stops after it
    while its wave-mate runs on."""
    cfg = get_config("gemma-2b", smoke=True)
    params = _port_params(cfg)
    prompt = np.asarray([7, 8, 9], np.int32)

    def run(eos):
        engine = ServeEngine(cfg, params, max_batch=2, max_len=32, seed=5)
        engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=6,
                              temperature=0.8, eos_id=eos))
        engine.submit(Request(uid=1, prompt=prompt, max_new_tokens=6))
        return engine.run_all()

    first = int(run(None)[0].tokens[0])
    stopped, mate = run(first)
    assert stopped.tokens.tolist() == [first]
    assert len(mate.tokens) == 6 and stopped.steps == mate.steps == 6


def test_run_serving_on_the_cpu():
    lines = []
    results = launch_serve.run_serving("zamba2-2.7b", smoke=True,
                                       n_requests=5, max_new=4, max_batch=2,
                                       seed=3, print_fn=lines.append,
                                       device="cpu")
    assert [r.uid for r in results] == [0, 1, 2, 3, 4]
    assert all(len(r.tokens) == 4 and r.error is None for r in results)
    assert lines[0].startswith("served 5 requests, 20 tokens")
    assert lines[0].endswith("on cpu")


def test_serve_main_runs_on_the_cpu(capsys):
    launch_serve.main(["--arch", "whisper-base", "--smoke", "--requests",
                       "2", "--max-new", "3"], device="cpu")
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.run_serving("gemma-2b", smoke=True, n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(get_config("gemma-2b", smoke=True))
