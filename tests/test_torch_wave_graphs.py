"""The wave engine's decode step with its position on the device and its
caches at fixed addresses, and the bookkeeping of its CUDA graph
(``serve.engine.WaveGraph``), on the CPU at smoke size.

* ``LM.decode_step`` takes ``pos`` as a 0-d tensor: for every wave block
  kind (dense, attn_local with a window of 5 that the ring wraps, moe,
  encdec, cross, rwkv, rglru) its logits and caches are bit-equal to an
  int ``pos``'s, and over several steps, a learned position clamped at
  the table's end among them, they stay within the wave tolerance of the
  reference's ``jax.jit(decode_step)`` at ``jnp.int32(pos)``.
* The wave engine allocates its caches once and copies each prefill's
  into them: for llama-vision, rwkv6 and recurrentgemma it gives the
  reference engine's tokens and timeless telemetry over waves of
  different prompt widths and a short last wave, and every cache tensor
  keeps its address.
* ``WaveGraph`` with ``torch.cuda``'s capture stood in by a context that
  runs the step (as in ``test_torch_serve_graphs.py``): the capture's
  counts are rolled back, each replay adds them, a rebound nested cache
  raises; ``cuda_graphs=True`` on a CPU wave model raises, the default
  runs the eager step.

Replayed steps on the card are in ``tests/test_torch_cuda.py``.  The
reference draws many leaves as constants; as in
``test_torch_serve_archs.py`` they get seeded noise, and the image
embeddings are drawn non-zero.  Tolerance: fp32 logits atol = rtol = 1e-4
(summation order only), as in ``test_torch_serve_wave.py``.
"""
import contextlib
import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels import counters, mpgemm  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    POS_EMBED_ROWS, build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeEngine, WaveGraph, _cache_tensors, _copy_caches,
)

TOL = dict(atol=1e-4, rtol=1e-4)
# Each wave block kind by the smoke model that runs it (and the config
# change it needs): recurrentgemma's local attention gets a window of 5,
# so that the 12-token prompts and the decode steps wrap its ring.
KINDS = {
    "dense": ("phi3-mini-3.8b", {}),
    "attn_local": ("recurrentgemma-2b", dict(local_attn_window=5)),
    "moe": ("granite-moe-1b-a400m", {}),
    "encdec": ("whisper-medium", {}),
    "cross": ("llama-3.2-vision-11b", {}),
    "rwkv": ("rwkv6-1.6b", {}),
    "rglru": ("recurrentgemma-2b", {}),
}
# The reference is held to the models of these kinds: recurrentgemma's
# with the window of 5 runs the attn_local and rglru kinds both.
REFERENCE_KINDS = ["dense", "moe", "encdec", "cross", "rwkv", "attn_local"]
# The wave-only architectures by the kind whose model serves them.
WAVE_ONLY = {"llama-3.2-vision-11b": "cross", "rwkv6-1.6b": "rwkv",
             "recurrentgemma-2b": "attn_local"}
NOISE = {"b_up": 0.1, "b_down": 0.1, "bias": 0.1, "scale": 0.3,
         "mu": 0.2, "mu_c": 0.2, "w_base": 1.0, "gn_scale": 0.3,
         "lambda_p": 0.5, "conv_b": 0.3, "gate_attn": 1.0, "gate_mlp": 1.0}
S, MAX_LEN = 12, 24


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if name in NOISE:
            noise = NOISE[name] * rng.standard_normal(np.shape(node))
            return (np.asarray(node) + noise).astype(np.float32)
        return node

    return walk(tree)


@functools.lru_cache(maxsize=None)
def _pair(arch, changes=(), policy="fp32"):
    """(reference model, its params, port model, its params) of one smoke
    config with ``changes`` ((field, value) pairs), the same tree."""
    jm = jbuild(dataclasses.replace(jcb.get(arch, smoke=True),
                                    **dict(changes)),
                policy=policy, remat=False)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), 0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = tbuild(dataclasses.replace(tcb.get(arch, smoke=True),
                                    **dict(changes)),
                policy=policy, device="cpu")
    return jm, jp, tm, tm.load_params(params_from_jax(tree, tm.cfg))


def _kind_pair(kind):
    arch, changes = KINDS[kind]
    return _pair(arch, tuple(sorted(changes.items())))


@functools.lru_cache(maxsize=None)
def _port_model(kind, policy):
    """The port's smoke model of ``kind`` alone, drawn from a torch seed,
    every constant leaf perturbed as in :func:`_perturbed`."""
    arch, changes = KINDS[kind]
    tm = tbuild(dataclasses.replace(tcb.get(arch, smoke=True), **changes),
                policy=policy, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if name in NOISE:
            return node + NOISE[name] * torch.randn(
                node.shape, generator=gen).to(node.dtype)
        return node

    return tm, walk(tm.init(gen))


def _batch(cfg, rng):
    """Two 12-token rows, the second left-padded from 8 (frames or image
    embeddings drawn non-zero) -> numpy arrays by name."""
    toks = rng.integers(2, cfg.vocab, (2, S)).astype(np.int32)
    toks[1, :4] = 0
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["audio_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _positions(cfg):
    """Three steps after the prompt; a learned table's model also one past
    the table's end, which both packages clamp to its last row."""
    pos = [S, S + 1, S + 2]
    if cfg.pos_embed == "learned":
        pos.append(POS_EMBED_ROWS + 3)
    return pos


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_tensor_pos_gives_the_int_pos_step_bit_for_bit(kind, policy):
    """The same prefill twice, then the same decode steps with ``pos`` an
    int and a 0-d tensor: equal logits and caches, bit for bit."""
    tm, tp = _port_model(kind, policy)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg, rng).items()}
    _, by_int = tm.prefill(tp, batch, max_len=MAX_LEN)
    _, by_tensor = tm.prefill(tp, batch, max_len=MAX_LEN)
    for pos in _positions(tm.cfg):
        tok = torch.from_numpy(rng.integers(2, tm.cfg.vocab, (2, 1)))
        want, _ = tm.decode_step(tp, tok, by_int, pos)
        got, out = tm.decode_step(tp, tok, by_tensor, torch.tensor(pos))
        assert out is by_tensor
        assert torch.equal(got, want), pos
        for a, b in zip(_cache_tensors(by_tensor), _cache_tensors(by_int)):
            assert torch.equal(a, b), pos


@pytest.mark.parametrize("kind", REFERENCE_KINDS)
def test_tensor_pos_steps_match_the_reference(kind):
    """A prefill, then steps at tensor positions against the reference's
    jitted decode step at ``jnp.int32(pos)`` (whisper also past its
    learned table's end): logits within the fp32 tolerance; the step
    launches no kernel on the CPU."""
    jm, jp, tm, tp = _kind_pair(kind)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    arrays = _batch(cfg, rng)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.from_numpy(v) for k, v in arrays.items()}
    _, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=MAX_LEN))(jp, jb)
    _, tc = tm.prefill(tp, tb, max_len=MAX_LEN)
    dec = jax.jit(jm.decode_step)
    k1 = mpgemm.mpgemm.launches
    v = cfg.vocab
    for pos in _positions(cfg):
        tok = rng.integers(2, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.int32(pos))
        tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tc,
                               torch.tensor(pos, dtype=torch.int32))
        got = tl.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(
            got[:, :v], np.asarray(jl.astype(jnp.float32))[:, :v], **TOL,
            err_msg=f"pos {pos}")
    assert mpgemm.mpgemm.launches == k1


def _requests(cls, vocab):
    """Three requests in waves of two: a wave 12 tokens wide, then a
    short last wave of one 5-token request."""
    rng = np.random.default_rng(3)
    spec = [(7, 6), (12, 4), (5, 6)]
    return [cls(uid=i, prompt=rng.integers(2, vocab, (n,)).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(spec)]


def _timeless(records, drop):
    return [{k: v for k, v in dataclasses.asdict(r).items() if k not in drop}
            for r in records]


@pytest.mark.parametrize("arch", list(WAVE_ONLY))
def test_wave_engine_with_fixed_caches_matches_reference(arch):
    """The reference engine's tokens and telemetry (all but the clock's
    fields), and every cache tensor at the address it was allocated at
    after each wave."""
    jm, jp, tm, tp = _kind_pair(WAVE_ONLY[arch])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    assert teng.graphs is None
    ptrs = [t.data_ptr() for t in _cache_tensors(teng.caches)]
    seen, run_wave = [], teng._run_wave

    def recorded(*args):
        out = run_wave(*args)
        seen.append([t.data_ptr() for t in _cache_tensors(teng.caches)])
        return out

    teng._run_wave = recorded
    vocab = jm.cfg.vocab
    want = jeng.generate(_requests(JRequest, vocab))
    got = teng.generate(_requests(Request, vocab))
    assert got == want and sorted(got) == [0, 1, 2]
    assert seen == [ptrs] * 2
    assert [t.requests for t in teng.telemetry] == [2, 1]
    clock = {"wall_s", "tokens_per_s", "prefill_s"}
    assert _timeless(teng.step_telemetry, clock) == \
        _timeless(jeng.step_telemetry, clock)
    assert _timeless(teng.telemetry, clock) == _timeless(jeng.telemetry,
                                                         clock)


def test_copy_caches_refuses_another_structure():
    dst = [{"self": {"k": torch.zeros(2, 3)}, "cross": {"k": torch.zeros(4)}}]
    src = [{"self": {"k": torch.ones(2, 3)}, "cross": {"k": torch.ones(4)}}]
    _copy_caches(dst, src)
    assert all(bool((t == 1).all()) for t in _cache_tensors(dst))
    src[0]["cross"]["k"] = torch.ones(5)
    with pytest.raises(ValueError, match="do not match"):
        _copy_caches(dst, src)


@pytest.mark.parametrize("arch", list(WAVE_ONLY))
def test_cuda_graphs_switch_of_a_cpu_wave_model(arch):
    """``True`` raises on a CPU model; ``None`` and ``False`` run the eager
    step."""
    tm, tp = _port_model(WAVE_ONLY[arch], "fp32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="CUDA model"):
            ServeEngine(tm, tp, batch_size=2, max_len=32, cuda_graphs=True)
        for switch in ({}, {"cuda_graphs": False}):
            eng = ServeEngine(tm, tp, batch_size=2, max_len=32, **switch)
            assert eng.graphs is None
            out = eng.generate(_requests(Request, tm.cfg.vocab)[:1])
            assert list(out) == [0] and out[0]


# --- WaveGraph's bookkeeping, the capture stood in ---------------------------

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


@pytest.fixture
def saved_counts():
    """Leave every launch count as the test found it."""
    before = counters.launch_counts()
    yield before
    counters.add_launch_counts(counters.count_delta(before,
                                                    counters.launch_counts()))
    assert counters.launch_counts() == before


class _CountingWaveModel:
    """A decode step that ticks K1 3 times and K4 once, as launches would,
    and writes whisper's nested cache in place (or, with ``rebind``,
    replaces its cross K)."""

    def __init__(self, rebind=False):
        self.rebind = rebind

    def decode_step(self, params, token, caches, pos):
        fns = counters.wrappers()
        fns["k1"].launches += 3
        fns["k4"].launches += 1
        cross = caches[0]["cross"]
        if self.rebind:
            cross["k"] = cross["k"].clone()
        else:
            cross["k"].add_(pos)
        return token.float() * 2, caches


def _wave_graph(model):
    caches = [{"self": {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)},
               "cross": {"k": torch.zeros(2, 4), "v": torch.zeros(2, 4)}}]
    return WaveGraph(model, {}, caches, torch.ones(2, 1, dtype=torch.long),
                     torch.tensor(5), stream=None, pool=None)


def test_wave_graph_rolls_back_the_capture_and_adds_each_replay(
        fake_capture, saved_counts, monkeypatch):
    kept = [torch.zeros(4)]
    monkeypatch.setattr(mpgemm, "split_workspaces", lambda: kept)
    g = _wave_graph(_CountingWaveModel())
    assert g.launches == {"k1": 3, "k4": 1}
    assert counters.launch_counts() == saved_counts     # rolled back
    assert g._held[3] is kept
    for n in (1, 2, 3):
        logits = g.replay()
        assert g.replays == g.graph.replayed == n
        counts = counters.launch_counts()
        assert counts["k1"] == saved_counts["k1"] + 3 * n
        assert counts["k4"] == saved_counts["k4"] + n
    assert logits is g.logits
    assert counters.count_delta(counters.launch_counts(), saved_counts) == {
        "k1": 9, "k4": 3}


def test_wave_graph_refuses_a_rebound_nested_cache(fake_capture,
                                                   saved_counts):
    with pytest.raises(RuntimeError, match="rebound a cache tensor"):
        _wave_graph(_CountingWaveModel(rebind=True))
