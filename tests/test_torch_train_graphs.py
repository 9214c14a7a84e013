"""The trainer's CUDA-graph switch and the captured step's bookkeeping, on
the CPU.

* ``Trainer(cuda_graphs=True)`` needs a CUDA model; the CPU default is the
  eager loop, whose losses are the plain loop's over ``make_train_step``.
* ``adamw_update`` keeps ``state.step`` as one tensor (a captured step
  reads and writes it at one address), and a checkpoint restores it.
* ``TrainStepGraph``'s bookkeeping, with ``torch.cuda``'s graph capture
  stood in by a context that runs the step: a capture rolls the launch
  counts back, each replay adds their delta, a rebound leaf of the state
  raises, and the real step of a smoke model rebinds none.
* ``Trainer.run`` with graphs, the card's streams and capture stood in:
  the first step runs eagerly, later ones replay, and every step's tokens
  land in the one static batch the graph reads.

Captured training on the card (the eager run's losses, grad norms and
state, a resume in the middle, launch counts over replays) is in
``tests/test_torch_cuda.py``.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointing import Checkpointer  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    StaticBatch, SyntheticLM, device_batch,
)
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig, AdamWState, adamw_init, adamw_update, tree_leaves,
)
from repro_torch.train import train_step as ts  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

SHAPE = ShapeConfig("t", 16, 2, "train")


def _model(arch="phi3-mini-3.8b"):
    return build_model(tcb.get(arch, smoke=True), policy="fp32",
                       device="cpu")


@pytest.fixture
def saved_counts():
    """Leave every launch count as the test found it."""
    before = counters.launch_counts()
    yield before
    counters.add_launch_counts(counters.count_delta(before,
                                                    counters.launch_counts()))
    assert counters.launch_counts() == before


# --- the switch --------------------------------------------------------------

def test_cuda_graphs_true_on_a_cpu_model_raises():
    with pytest.raises(ValueError, match="needs a CUDA model"):
        Trainer(_model(), SHAPE, TrainerConfig(steps=1), cuda_graphs=True)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_cpu_default_is_the_eager_loop_with_the_plain_losses(arch):
    """A CPU trainer captures nothing, with or without ``cuda_graphs=False``,
    and its losses and state are those of the plain loop: one host batch
    to the device and one ``make_train_step`` call a step."""
    model = _model(arch)
    tcfg = TrainerConfig(steps=3, log_every=1000, opt=AdamWConfig(lr=1e-3))
    runs = []
    for switch in ({}, {"cuda_graphs": False}):
        tr = Trainer(model, SHAPE, tcfg, seed=3, **switch)
        assert tr.cuda_graphs is False
        params, opt = tr.run()
        assert tr.graph is None and tr.graph_pool_bytes() == 0
        runs.append(([r["loss"] for r in tr.metrics_log],
                     [r["grad_norm"] for r in tr.metrics_log],
                     tree_leaves(params) + tree_leaves(opt)))
    tr = Trainer(model, SHAPE, tcfg, seed=3)
    params, opt = tr.init_state()
    step = ts.make_train_step(model, tcfg.opt, total_steps=tcfg.steps)
    pipe = SyntheticLM(model.cfg.vocab, SHAPE.global_batch, SHAPE.seq_len,
                       seed=3)
    losses, norms = [], []
    for _ in range(tcfg.steps):
        params, opt, met = step(params, opt,
                                device_batch(pipe.next_batch(), "cpu"))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    want = tree_leaves(params) + tree_leaves(opt)
    for got_losses, got_norms, got in runs:
        assert got_losses == losses and got_norms == norms
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(opt.step) == 3


# --- AdamW's step in place ---------------------------------------------------

def test_adamw_keeps_the_step_tensor_and_a_checkpoint_restores_it(tmp_path):
    p = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    opt = adamw_init(p)
    step, ptr = opt.step, opt.step.data_ptr()
    g = {"w": torch.full((3, 2), 0.5), "b": torch.full((2,), -0.5)}
    for want in (1, 2):
        p, opt, _ = adamw_update(g, opt, p, AdamWConfig(lr=0.1),
                                 {"w": True, "b": False})
        assert opt.step is step and step.data_ptr() == ptr
        assert int(step) == want and step.dtype == torch.int32
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"params": p, "opt": opt})
    tree, _ = ck.restore({"params": p, "opt": adamw_init(p)})
    got = tree["opt"]
    assert isinstance(got, AdamWState) and int(got.step) == 2
    assert got.step.dtype == torch.int32 and got.step is not step
    for a, b in zip(tree_leaves(tree), tree_leaves({"params": p,
                                                    "opt": opt})):
        assert torch.equal(a, b)


# --- TrainStepGraph's bookkeeping, the capture stood in ---------------------

class _FakeGraph:
    replayed = 0

    def replay(self):
        self.replayed += 1


@contextlib.contextmanager
def _run_instead_of_capture(graph, pool=None, stream=None):
    yield


@pytest.fixture
def fake_capture(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _run_instead_of_capture)


def _state():
    params = {"w": torch.zeros(3, 2), "layers": [{"b": torch.zeros(2)}]}
    return params, adamw_init(params)


def _counting_step(rebind=None):
    """A step that ticks K1 7 times and K4 twice, as launches would, and
    updates the state in place (or, with ``rebind``, replaces that
    leaf)."""

    def step(params, opt, batch):
        fns = counters.wrappers()
        fns["k1"].launches += 7
        fns["k4"].launches += 2
        params["w"].add_(batch["tokens"].float().mean())
        opt.step.add_(1)
        if rebind == "param":
            params["layers"][0]["b"] = params["layers"][0]["b"] + 1
        elif rebind == "moment":
            opt.m["w"] = opt.m["w"].clone()
        elif rebind == "step":         # the old ``step = state.step + 1``
            opt = AdamWState(opt.step + 1, opt.m, opt.v)
        return params, opt, {"loss": params["w"].sum()}

    return step


def test_train_step_graph_rolls_back_the_capture_and_adds_each_replay(
        fake_capture, saved_counts, monkeypatch):
    from repro_torch.kernels import mpgemm
    kept = [torch.zeros(4)]
    monkeypatch.setattr(mpgemm, "split_workspaces", lambda: kept)
    params, opt = _state()
    batch = {"tokens": torch.ones(2, 3, dtype=torch.int32)}
    g = ts.TrainStepGraph(_counting_step(), params, opt, batch, stream=None,
                          pool=None)
    assert g.launches == {"k1": 7, "k4": 2}
    assert counters.launch_counts() == saved_counts     # rolled back
    assert g._held[0] is params and g._held[1] is opt
    assert g._held[2] is batch and g._held[3] is kept
    for n in (1, 2, 3):
        met = g.replay()
        assert g.replays == g.graph.replayed == n
        counts = counters.launch_counts()
        assert counts["k1"] == saved_counts["k1"] + 7 * n
        assert counts["k4"] == saved_counts["k4"] + 2 * n
    assert met is g.metrics
    assert counters.count_delta(counters.launch_counts(), saved_counts) == {
        "k1": 21, "k4": 6}


@pytest.mark.parametrize("leaf", ["param", "moment", "step"])
def test_train_step_graph_refuses_a_rebound_leaf(fake_capture, saved_counts,
                                                 leaf):
    params, opt = _state()
    with pytest.raises(RuntimeError, match="rebound a leaf"):
        ts.TrainStepGraph(_counting_step(rebind=leaf), params, opt,
                          {"tokens": torch.ones(2, 3, dtype=torch.int32)},
                          stream=None, pool=None)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_the_real_step_rebinds_no_leaf(fake_capture, saved_counts,
                                       microbatches):
    """``make_train_step`` of a smoke model (MoE, so the aux loss and the
    router run too) writes every leaf of the state in place: the capture
    accepts it and the step counter reads 2 after the eager step and the
    stood-in capture, which runs the step once more."""
    model = _model("granite-moe-1b-a400m")
    tr = Trainer(model, SHAPE, TrainerConfig(
        steps=2, microbatches=microbatches))
    params, opt = tr.init_state()
    static = StaticBatch(tr.pipeline.next_batch(), "cpu")
    batch = static.fill(tr.pipeline.next_batch())
    params, opt, _ = tr.step_fn(params, opt, batch)
    g = ts.TrainStepGraph(tr.step_fn, params, opt, batch, stream=None,
                          pool=None)
    assert int(opt.step) == 2 and g.launches == {}
    assert sorted(g.metrics) == ["clip_scale", "grad_norm", "loss",
                                 "lr_scale"]


# --- the trainer's loop with graphs, the card stood in -----------------------

class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_card(fake_capture, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


def test_trainer_fills_the_static_batch_in_place(fake_card, saved_counts,
                                                 monkeypatch):
    """Step 0 runs eagerly on the static batch, the capture reads the same
    tensors, and before each replay the trainer has copied that step's
    tokens into them."""
    model = _model()
    tr = Trainer(model, SHAPE, TrainerConfig(steps=4, log_every=1000),
                 seed=5)
    tr.cuda_graphs = True                # the CPU model stands in
    seen, replayed = [], []
    step_fn = tr.step_fn

    def recorded(params, opt, batch):
        seen.append(batch["tokens"])
        return step_fn(params, opt, batch)

    tr.step_fn = recorded
    replay = ts.TrainStepGraph.replay

    def recorded_replay(self):
        tokens = self._held[2]["tokens"]
        replayed.append((tokens, tokens.clone()))
        return replay(self)

    monkeypatch.setattr(ts.TrainStepGraph, "replay", recorded_replay)
    tr.run()
    assert tr.graph is not None and tr.graph.replays == 3
    assert len(seen) == 2 and seen[0] is seen[1]     # eager, then capture
    assert all(t is seen[0] for t, _ in replayed)
    pipe = SyntheticLM(model.cfg.vocab, SHAPE.global_batch, SHAPE.seq_len,
                       seed=5)
    want = [pipe.next_batch()["tokens"] for _ in range(4)]
    assert [r["step"] for r in tr.metrics_log] == [0, 1, 2, 3]
    for (_, got), w in zip(replayed, want[1:]):
        assert np.array_equal(got.numpy(), w)
    assert np.array_equal(seen[0].numpy(), want[-1])


def test_static_batch_refuses_another_shape():
    like = {"tokens": np.zeros((2, 5), np.int32)}
    static = StaticBatch(like, "cpu")
    t = static.fill({"tokens": np.arange(10, dtype=np.int32).reshape(2, 5)})
    assert t["tokens"] is static.tensors["tokens"]
    assert t["tokens"].dtype == torch.int32
    with pytest.raises(ValueError, match="shape"):
        static.fill({"tokens": np.zeros((1, 5), np.int32)})
    with pytest.raises(ValueError, match="holds"):
        static.fill({"tokens": like["tokens"], "x": like["tokens"]})


def test_train_cli_prints_the_graphs_line(capsys):
    from repro_torch.launch import train as ttrain
    tr, _, _ = ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                            "--seq", "16"])
    assert tr.graph is None
    assert "[train] CUDA graphs: none captured (off, the eager loop)" in \
        capsys.readouterr().out
