"""The port's BENCH writer hands a pooled pass's device pool to every layer
that places work (the engine, the fixed-genome replay and the flexion
campaign), and the other passes to none, on the CPU."""
import pytest

pytest.importorskip("torch")

from repro_torch.bench import run as writer  # noqa: E402


def test_pooled_pass_hands_its_pool_to_every_layer(tmp_path, monkeypatch):
    """fig13 through the writer, a batched and a ``campaign-d0,0`` pass:
    the pooled pass runs the engine, the fixed-genome replay and the
    flexion campaign on its pool (a depth-2 queue on the CPU device), and
    the batched pass runs none of them pooled.  The float32 torch flexion
    backend is the one that queues chunks on a device."""
    from repro_torch.core import engine, flexion_batched, mapper
    from repro_torch.dist.pool import InFlightQueue
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REPRO_DEVICES", raising=False)
    monkeypatch.setenv("REPRO_FLEXION_BACKEND", "torch")
    depths = {}
    label = []

    def recording(layer):
        class Queue(InFlightQueue):
            def __init__(self, depth, collect):
                depths.setdefault((label[-1], layer), set()).add(depth)
                super().__init__(depth=depth, collect=collect)
        return Queue
    for layer, mod in (("engine", engine), ("replay", mapper),
                       ("flexion", flexion_batched)):
        monkeypatch.setattr(mod, "InFlightQueue", recording(layer))
    warm = writer._warm_engine

    def warm_and_mark(engine_label, mode, device):
        label.append(engine_label)
        warm(engine_label, mode, device)
    monkeypatch.setattr(writer, "_warm_engine", warm_and_mark)
    assert writer.main(["fig13", "--mode", "fast", "--engines", "batched",
                        "--devices", "0,0"], device="cpu") == 0
    assert label == ["batched", "campaign-d0,0"]
    for layer in ("replay", "flexion"):
        assert depths[("batched", layer)] == {1}, layer
    for layer in ("engine", "replay", "flexion"):
        assert depths[("campaign-d0,0", layer)] == {2}, layer
    assert depths.get(("batched", "engine"), {1}) == {1}
