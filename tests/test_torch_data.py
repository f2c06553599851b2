"""The port's data pipeline against the JAX package's: for gemma-2b (text),
internvl2-1b (vision stub) and whisper-base (audio stub), the batches of
``make_dataset(...).batch_at(step)`` equal the reference's byte for byte
over seeds, steps and host shardings; ``iterate(start_step)`` is
restart-exact; tests/test_fault_tolerance.py's pipeline check on the
port."""
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import make_dataset as j_make_dataset  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402

ARCHS = ("gemma-2b", "internvl2-1b", "whisper-base")


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,n_hosts", [(0, 1), (5, 2), (11, 4)])
def test_batches_equal_the_reference_byte_for_byte(arch, seed, n_hosts):
    cfg, jcfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    for host_id, step in itertools.product(range(n_hosts), (0, 1, 17)):
        got = make_dataset(cfg, seq_len=24, global_batch=4, seed=seed,
                           n_hosts=n_hosts, host_id=host_id).batch_at(step)
        want = j_make_dataset(jcfg, seq_len=24, global_batch=4, seed=seed,
                              n_hosts=n_hosts,
                              host_id=host_id).batch_at(step)
        _same(got, want)
        assert got["tokens"].shape == (4 // n_hosts, 24)
        frontend = {"internvl2-1b": "vision_embeds",
                    "whisper-base": "audio_frames"}.get(arch)
        if frontend:
            assert frontend in got


def test_iterate_is_restart_exact():
    ds = make_dataset(get_config("gemma-2b", smoke=True), seq_len=16,
                      global_batch=2, seed=3)
    first = list(itertools.islice(ds.iterate(0), 6))
    again = list(itertools.islice(ds.iterate(4), 2))
    for a, b in zip(first[4:], again):
        _same(a, b)
    for step, batch in enumerate(first):
        _same(batch, ds.batch_at(step))


def test_data_pipeline_deterministic_and_restart_exact():
    cfg = get_config("gemma-2b", smoke=True)
    ds1 = make_dataset(cfg, seq_len=32, global_batch=4, seed=5)
    ds2 = make_dataset(cfg, seq_len=32, global_batch=4, seed=5)
    for step in (0, 3, 17):
        a, b = ds1.batch_at(step), ds2.batch_at(step)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    # host sharding partitions the global batch
    h0 = make_dataset(cfg, 32, 4, seed=5, n_hosts=2, host_id=0)
    h1 = make_dataset(cfg, 32, 4, seed=5, n_hosts=2, host_id=1)
    assert h0.batch_at(0)["tokens"].shape[0] == 2
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])
