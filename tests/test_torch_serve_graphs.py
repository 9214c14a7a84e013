"""The continuous engine's CUDA-graph switch and the launch counts behind
it, on the CPU.

* ``ServeEngine(cuda_graphs=True)`` needs a CUDA model; the CPU default is
  the eager step, whose greedy tokens stay the reference engine's (the JAX
  package's ``ServeEngine`` on its default CPU backend).
* ``kernels/counters.py``: the snapshot, delta and add round-trip on every
  count ``chip_smoke.py`` reads, and ``chip_smoke.py`` reads them there.
* ``StepGraph``'s bookkeeping, with ``torch.cuda``'s graph capture stood in
  by a context that runs the step: a capture rolls the launch counts back,
  each replay adds their delta, a rebound KV pool raises.

Captured steps on the card (the same tokens, bit-equal logits, equal
launch counts, a workspace grown after a capture) are in
``tests/test_torch_cuda.py``.
"""
import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as jcb  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels import counters, mpgemm  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeEngine, StepGraph,
)

ROOT = Path(__file__).resolve().parents[1]

# Every count chip_smoke.py reads, by name -> (kernel, wrapper attribute).
ATTRS = {"ta": "trans_a_launches", "tb": "trans_b_launches",
         "wgmma": "wgmma_launches", "tf32x3": "tf32x3_launches",
         "fma": "fma_launches", "split": "split_launches",
         "stream": "stream_launches"}
NAMES = (["k1", "k1g", "k2", "k2g", "k3", "k3g", "k4", "k5", "k6", "k7"]
         + [f"{k}_{s}" for k in ("k1", "k1g") for s in ("ta", "tb", "wgmma",
                                                        "tf32x3", "fma")]
         + [f"{k}_{s}" for k in ("k2", "k2g", "k3", "k3g")
            for s in ("ta", "wgmma")]
         + [f"{k}_{s}" for k in ("k4", "k5") for s in ("wgmma", "split")]
         + ["k4_tf32x3", "k6_stream", "k7_stream"])


def _attr(name):
    key, _, suffix = name.partition("_")
    return counters.wrappers()[key], ATTRS.get(suffix, "launches")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def saved_counts():
    """Leave every launch count as the test found it."""
    before = counters.launch_counts()
    yield before
    counters.add_launch_counts(counters.count_delta(before,
                                                    counters.launch_counts()))
    assert counters.launch_counts() == before


def test_counts_name_every_count_chip_smoke_reads():
    assert sorted(counters.launch_counts()) == sorted(NAMES)
    assert _chip_smoke()._read_counters() == counters.launch_counts()


@pytest.mark.parametrize("name", NAMES)
def test_count_snapshot_delta_and_add_round_trip(name, saved_counts):
    fn, attr = _attr(name)
    setattr(fn, attr, getattr(fn, attr) + 3)
    delta = counters.count_delta(counters.launch_counts(), saved_counts)
    assert delta == {name: 3}
    counters.add_launch_counts(delta, times=-1)
    assert counters.launch_counts() == saved_counts
    counters.add_launch_counts(delta)
    counters.add_launch_counts(delta)
    want = dict(saved_counts, **{name: saved_counts[name] + 6})
    assert counters.launch_counts() == want


def test_reset_zeroes_every_count(saved_counts):
    for name in NAMES:
        fn, attr = _attr(name)
        setattr(fn, attr, getattr(fn, attr) + 1)
    counters.reset_launch_counts()
    assert set(counters.launch_counts().values()) == {0}


# --- the switch --------------------------------------------------------------

def _pair(arch, seed=0):
    jm = jbuild(jcb.get(arch, smoke=True), policy="fp32", remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = tcb.get(arch, smoke=True)
    tm = tbuild(tcfg, policy="fp32", device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg))
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def phi3_pair():
    return _pair("phi3-mini-3.8b")


def test_cuda_graphs_on_a_cpu_model_raises(phi3_pair):
    _, _, tm, tp = phi3_pair
    with pytest.raises(ValueError, match="CUDA model"):
        ServeEngine(tm, tp, max_len=32, max_batch=2, page_size=8,
                    cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA model"):
        ServeEngine(tm, tp, max_len=32, batch_size=2, cuda_graphs=True)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_cpu_default_is_the_eager_step_with_the_reference_tokens(arch):
    jm, jp, tm, tp = _pair(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, jm.cfg.vocab, (n,)).astype(np.int32)
               for n in (11, 20, 3)]
    kw = dict(max_len=48, max_batch=2, page_size=8)
    want = JEngine(jm, jp, **kw).generate(
        [JRequest(uid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    for switch in ({}, {"cuda_graphs": False}):
        eng = ServeEngine(tm, tp, **kw, **switch)
        assert eng.graphs is None
        got = eng.generate([Request(uid=i, prompt=p, max_new_tokens=5)
                            for i, p in enumerate(prompts)])
        assert got == {r: list(t) for r, t in want.items()}


# --- StepGraph's bookkeeping, the capture stood in ---------------------------

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


class _CountingModel:
    """A step that ticks K1 5 times and K5 twice, as launches would, and
    writes its pool in place (or, with ``rebind``, replaces it)."""

    def __init__(self, rebind=False):
        self.rebind = rebind

    def paged_step(self, params, tokens, caches, bt, q_start, n_valid):
        fns = counters.wrappers()
        fns["k1"].launches += 5
        fns["k5"].launches += 2
        if self.rebind:
            caches[0]["k_pages"] = caches[0]["k_pages"].clone()
        else:
            caches[0]["k_pages"].add_(1)
        return tokens.float() * 2, caches


def _graph(model):
    caches = [{"k_pages": torch.zeros(3, 2), "v_pages": torch.zeros(3, 2)}]
    inputs = [torch.ones(2, 1, dtype=torch.int32)] + [
        torch.zeros(2, dtype=torch.int32)] * 3
    return StepGraph(model, {}, caches, inputs, stream=None, pool=None)


def test_step_graph_rolls_back_the_capture_and_adds_each_replay(
        fake_capture, saved_counts, monkeypatch):
    kept = [torch.zeros(4)]
    monkeypatch.setattr(mpgemm, "split_workspaces", lambda: kept)
    g = _graph(_CountingModel())
    assert g.launches == {"k1": 5, "k5": 2}
    assert counters.launch_counts() == saved_counts     # rolled back
    assert g._held[3] is kept
    for n in (1, 2, 3):
        logits = g.replay()
        assert g.replays == g.graph.replayed == n
        counts = counters.launch_counts()
        assert counts["k1"] == saved_counts["k1"] + 5 * n
        assert counts["k5"] == saved_counts["k5"] + 2 * n
    assert logits is g.logits
    assert counters.count_delta(counters.launch_counts(), saved_counts) == {
        "k1": 15, "k5": 6}


def test_step_graph_refuses_a_rebound_pool(fake_capture, saved_counts):
    with pytest.raises(RuntimeError, match="rebound a KV pool"):
        _graph(_CountingModel(rebind=True))
