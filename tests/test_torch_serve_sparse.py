"""The port's tile-sparse serving path against the JAX package's, on the
CPU.

The reference sparsifies its parameter tree (``repro.sparse.sparsify_params``
with the same blocks the port is handed) and ``params_from_jax`` carries
the sparse leaves across byte for byte -- a stacked leaf sliced per layer,
its shared layout kept -- so both packages compute the same function.  One
``paged_step`` must give the same logits on the live rows, and the
engines the same greedy tokens under fp32.  Under fp32 the reference
runs its default CPU backend (XLA, which densifies each sparse operand:
zeros at the pruned tiles, the same products the tile walk makes, summed
in another order).  Under bf16 and int8 it runs
``gemm_backend("interpret")``, its tile-sparse Pallas body, which the port
ports: under int8 its XLA backend would re-quantize a densified payload
per tensor, and under bf16 granite's XLA and interpret logits differ from
each other by 0.077 in one row (a summation order that moves a bf16
rounding flips a top-k routing), while the port is within 5e-3 of the
interpret ones.

Tolerances, as ``test_torch_serve_packed.py``: fp32 logits atol = rtol =
1e-4 (summation order only); bf16 and int8 logits atol = rtol = 3e-2:
both round every GEMM output and the residual stream to bf16, the
reference's attention oracle rounds the softmax weights to bf16 before
P·V where the port keeps them in f32, and a bf16 ulp at the logits' scale
(about 1) is 2**-8.  Idle rows are excluded.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.sparse import sparse_param_density as jsparse_density  # noqa: E402,E501
from repro.sparse import sparsify_params as jsparsify  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    TileSparseOperand, sparse_param_density,
)
from repro_torch.sparse import sparsify_params as tsparsify  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2),
       "int8": dict(atol=3e-2, rtol=3e-2)}
BLOCKS = (32, 32)

# Two units of (dense, attn_local) stacked, plus an unstacked tail layer:
# params_from_jax slices stacked sparse payloads and carries plain ones.
MIXED = dict(block_pattern=("dense", "attn_local", "dense", "attn_local",
                            "dense"),
             local_attn_window=5, vocab=500, n_layers=5)


def _configs(arch):
    if arch == "mixed":
        j = dataclasses.replace(jcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        t = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        return j, t
    return jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)


def _sparse_pair(arch, policy, method="magnitude", seed=0):
    jc, tc = _configs(arch)
    jm = jbuild(jc, policy=policy, remat=False)
    jp = jsparsify(jm.init(jax.random.PRNGKey(seed)), density=0.5,
                   method=method, nm=(2, 4), policy=policy, blocks=BLOCKS)
    tm = tbuild(tc, policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tc))
    return jm, jp, tm, tp


def _sparse_leaves(tree):
    if isinstance(tree, TileSparseOperand):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _sparse_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _sparse_leaves(v)


def _counts():
    return (tk.mpgemm.launches, tk.mpgemm_grouped.launches,
            tk.mpgemm_sparse.launches, tk.mpgemm_sparse_grouped.launches)


def _step_both(jm, jp, tm, tp):
    """A context chunk, then a mixed step (a full row, a row with dead
    columns, an idle row); -> (port logits, reference logits, live)."""
    ps, n_pages, b, c, w = 8, 12, 3, 8, 5
    rng = np.random.default_rng(0)
    bt = np.zeros((b, w), np.int32)
    bt[0, :3] = [3, 5, 7]
    bt[1, :2] = [2, 9]
    q_start = np.array([c, 0, 0], np.int32)
    n_valid = np.array([c, 5, 0], np.int32)
    toks = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    pre = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    zeros, first = np.zeros(b, np.int32), np.array([c, 0, 0], np.int32)

    jc = jm.init_paged_caches(n_pages, ps)
    step = jax.jit(jm.paged_step)
    _, jc = step(jp, jnp.asarray(pre), jc, jnp.asarray(bt),
                 jnp.asarray(zeros), jnp.asarray(first))
    want, _ = step(jp, jnp.asarray(toks), jc, jnp.asarray(bt),
                   jnp.asarray(q_start), jnp.asarray(n_valid))
    want = np.asarray(want.astype(jnp.float32))

    tc = tm.init_paged_caches(n_pages, ps)
    tt = torch.from_numpy
    tm.paged_step(tp, tt(pre), tc, tt(bt), tt(zeros), tt(first))
    got, _ = tm.paged_step(tp, tt(toks), tc, tt(bt), tt(q_start),
                           tt(n_valid))
    return got.float().numpy(), want, n_valid > 0


@pytest.mark.parametrize("arch,policy,method", [
    ("phi3-mini-3.8b", "fp32", "magnitude"),
    ("phi3-mini-3.8b", "bf16", "magnitude"),
    ("phi3-mini-3.8b", "int8", "magnitude"),
    ("mixed", "bf16", "nm"),
    ("mixed", "int8", "nm"),
    ("granite-moe-1b-a400m", "fp32", "magnitude"),
    ("granite-moe-1b-a400m", "bf16", "magnitude"),
    ("granite-moe-1b-a400m", "int8", "nm"),
])
def test_sparse_paged_step_matches_reference(arch, policy, method):
    jm, jp, tm, tp = _sparse_pair(arch, policy, method)
    ops = list(_sparse_leaves(tp))
    moe = tm.cfg.family == "moe"
    per_layer = 7
    assert len(ops) == per_layer * len(tm.cfg.pattern) + (
        0 if tm.cfg.tie_embeddings else 1)
    assert {op.layout.dtype for op in ops} == {
        {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}[policy]}
    if moe:
        layer = tp["layers"][0]
        assert layer["w_up"].layout.g == tm.cfg.n_experts
        assert isinstance(layer["router"], torch.Tensor)
    assert sparse_param_density(tp, tm.cfg) < 0.75
    before = _counts()
    backend = "xla" if policy == "fp32" else "interpret"
    with jcfg.gemm_backend(backend):
        got, want, live = _step_both(jm, jp, tm, tp)
    np.testing.assert_allclose(got[live], want[live], **TOL[policy])
    assert np.isfinite(got).all()
    assert _counts() == before                  # plain versions on the CPU


@pytest.mark.parametrize("arch,want", [("phi3-mini-3.8b", 0.5145),
                                       ("mixed", 0.5189)])
def test_sparse_param_density_matches_reference(arch, want):
    """Each group of layers that shares a pattern counts once, as the
    reference's stacked leaf does: the port's figure equals the
    reference's on the same weights (carried over, and sparsified by the
    port from the same dense draw)."""
    jm, jp, tm, tp = _sparse_pair(arch, "fp32")
    ref = jsparse_density(jp)
    assert round(ref, 4) == want
    assert sparse_param_density(tp, tm.cfg) == ref
    dense = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), tm.cfg)
    own = tsparsify(dense, cfg=tm.cfg, density=0.5, method="magnitude",
                    policy="fp32", blocks=BLOCKS)
    assert sparse_param_density(own, tm.cfg) == ref


def test_params_from_jax_keeps_the_shared_layout_of_a_stack():
    """Layer u of stack position p is the reference's stacked payload at
    index u, under the one layout of the stack."""
    jm, jp, tm, tp = _sparse_pair("mixed", "int8", "nm")
    for p in range(2):
        want = jp["stack"][p]["mlp"]["w_down"]
        for u in range(2):
            got = tp["layers"][2 * u + p]["mlp"]["w_down"]
            assert got.layout.indices == want.layout.indices
            assert got.payload.numpy().tobytes() == np.ascontiguousarray(
                np.asarray(want.payload)[u]).tobytes()
            assert np.array_equal(got.scales.numpy(),
                                  np.asarray(want.scales)[u])
    tail = tp["layers"][4]["mlp"]["w_down"]
    assert tail.layout.indices == jp["tail"][0]["mlp"]["w_down"].layout.indices


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_sparse_engine_greedy_tokens_match_reference(arch):
    """Three requests through two slots (fp32): the same greedy tokens."""
    jm, jp, tm, tp = _sparse_pair(arch, "fp32")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tm.cfg.vocab, (n,)).astype(np.int32)
               for n in (11, 4, 19)]
    out = []
    for eng in (JEngine(jm, jp, max_len=64, max_batch=2, page_size=8),
                ServeEngine(tm, tp, max_len=64, max_batch=2, page_size=8)):
        done = {}
        for i, p in enumerate(prompts):
            eng.add_request(p, max_new_tokens=6, uid=i)
        steps = 0
        while eng.pending:
            for r in eng.step():
                done[r.uid] = r.out_tokens
            steps += 1
            assert steps < 200
        out.append(done)
    assert sorted(out[1]) == [0, 1, 2]
    assert out[1] == out[0]


def test_sparse_wave_engine_matches_reference():
    """The wave engine on sparse weights (fp32): the same greedy tokens."""
    jm, jp, tm, tp = _sparse_pair("phi3-mini-3.8b", "fp32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    rng = np.random.default_rng(3)
    spec = [(7, 6), (12, 4), (5, 6)]

    def reqs(cls):
        return [cls(uid=i, prompt=rng.integers(2, tm.cfg.vocab, (n,)).astype(
            np.int32), max_new_tokens=m) for i, (n, m) in enumerate(spec)]

    want = jeng.generate(reqs(JRequest))
    rng = np.random.default_rng(3)
    got = teng.generate(reqs(Request))
    assert got == want and sorted(got) == [0, 1, 2]


def test_own_init_sparsifies_every_gemm_weight():
    cfg = tcb.get("granite-moe-1b-a400m", smoke=True)
    m = tbuild(cfg, policy="int8", device="cpu")
    p = m.init(torch.Generator().manual_seed(0), sparsity=0.5,
               sparsity_method="nm", sparsity_blocks=(16, 16))
    layer = p["layers"][0]
    for name in ("w_gate", "w_up", "w_down"):
        assert layer[name].layout.g == cfg.n_experts
        assert layer[name].layout.dtype == "int8"
    assert layer["attn"]["wq"].layout.density == 0.5
    assert layer["router"].dtype == torch.float32
    assert p["embed"].dtype == torch.bfloat16
    # Every layer of the stack shares one pattern.
    assert len({lay["w_up"].layout.indices for lay in p["layers"]}) == 1
    with pytest.raises(ValueError, match="mutually exclusive"):
        m.init(torch.Generator().manual_seed(0), pack=True, sparsity=0.5)
    with pytest.raises(ValueError, match="sparsity"):
        m.init(torch.Generator().manual_seed(0), sparsity=1.0)


def _cli(capsys, *args):
    rc = tserve.main(["--smoke", "--device", "cpu", "--requests", "2",
                      "--max-new", "4", *args])
    out = capsys.readouterr().out
    assert rc == 0
    return out


def test_cli_sparsity_on_cpu(capsys):
    out = _cli(capsys, "--sparsity", "0.5", "--sparsity-blocks", "32", "32")
    assert "tile-sparse static weights" in out and "WARNING" not in out
    density = float(out.split("tile density ")[1].split()[0])
    assert 0.5 <= density < 0.6                  # ceil of each budget
    assert "on cpu: 2 requests, 8 tokens" in out
    out = _cli(capsys, "--sparsity", "0.5")       # 96-wide smoke weights
    assert "WARNING: effective tile density" in out
    out = _cli(capsys, "--arch", "granite-moe-1b-a400m", "--policy", "int8",
               "--sparsity", "0.3", "--sparsity-method", "nm",
               "--sparsity-blocks", "16", "16", "--engine", "wave")
    assert "keeping 3 of every 4 k-tiles" in out
    assert "engine=wave" in out


@pytest.mark.parametrize("args,msg", [
    (["--pack", "--sparsity", "0.5"], "mutually exclusive"),
    (["--sparsity", "1.0"], "must be in"),
    (["--sparsity", "-0.1"], "must be in"),
])
def test_cli_sparsity_argument_checks(args, msg):
    with pytest.raises(SystemExit, match=msg):
        tserve.main(["--smoke", "--device", "cpu", *args])
