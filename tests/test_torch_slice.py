"""Slice 1 of the port end to end on the CPU, against the JAX package:
BERT (seq 64) searched on InFlex-0000 and FullFlex-1111, each searched
mapping lowered onto the tiled matmul, run through the kernel's plain
version, and checked against the oracle."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import kernel_bridge as j_kb  # noqa: E402
from repro.core import mapper as j_mapper  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro.core import workloads as j_wl  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.core import convert  # noqa: E402
from repro_torch.core import kernel_bridge as t_kb  # noqa: E402
from repro_torch.core.workloads import bert_base  # noqa: E402
from repro_torch.kernels import cast, dtype_for_bits  # noqa: E402
from repro_torch.kernels import tiled_matmul as t_tm  # noqa: E402

CPU = "cpu"
BUDGET = dict(population=16, generations=8)


@pytest.mark.parametrize("cls", ["0000", "1111"])
def test_bert_search_lower_run_parity(cls):
    js = j_spec.inflex_baseline() if cls == "0000" else \
        j_spec.make_variant(cls)
    ts = convert.spec_from_dict(dataclasses.asdict(js))
    j_layers = j_wl.bert_base(seq=64)
    t_layers = bert_base(seq=64)
    assert [dataclasses.asdict(l) for l in t_layers] == \
        [dataclasses.asdict(l) for l in j_layers]
    j_res = j_mapper.search_model(j_layers, js, j_mapper.GAConfig(**BUDGET))
    t_res = core.search_model(t_layers, ts, core.GAConfig(**BUDGET),
                              device=CPU)
    np.testing.assert_allclose(t_res.runtime, j_res.runtime, rtol=1e-6)

    runner = t_kb.MeasuredRunner(device=CPU)
    for layer, jr, tr in zip(t_layers, j_res.per_layer, t_res.per_layer):
        assert dataclasses.asdict(tr.mapping) == dataclasses.asdict(
            jr.mapping)
        m, kred, n = layer.dims[:3]
        wl = t_kb.matmul_workload(m, n, kred)
        cfg = t_kb.lower_mapping(wl, tr.mapping)
        assert t_kb.config_legal(wl, cfg)
        assert cfg.bits == 8                      # 8-bit native HWConfig
        x, y = (cast(a, dtype_for_bits(cfg.bits))
                for a in runner.inputs_for(wl))
        bm, bn, bk = cfg.block
        got = t_kb.run_config(wl, cfg, runner.inputs_for(wl))
        assert torch.equal(got, t_tm.tiled_matmul_plain(
            x, y, bm=bm, bn=bn, bk=bk, order=cfg.order))
        ok, err = t_kb.parity_check(wl, cfg, runner.inputs_for(wl))
        oracle = np.asarray(j_ref.matmul_ref(jnp.asarray(x.numpy()),
                                             jnp.asarray(y.numpy())))
        if cfg.order == "out":
            # one saturating cast after all of K: the reference oracle
            assert ok and np.array_equal(got.numpy(), oracle)
        else:
            # per-K-block int8 casts and wrapping adds: equal to the oracle
            # exactly where no partial or running sum left int8's range
            assert ok == np.array_equal(got.numpy(), oracle)
        # the JAX bridge lowers the same mapping the same way wherever the
        # TPU and Hopper alignments pick the same divisors
        j_cfg = j_kb.lower_mapping(j_kb.matmul_workload(m, n, kred),
                                   jr.mapping)
        assert j_cfg.order == cfg.order and j_cfg.bits == cfg.bits
