"""The port's MoE serving path (granite-moe-smoke) against the JAX
package's, on the CPU.

``params_from_jax`` carries a reference granite parameter tree across --
dense, or packed by ``repro.packing.pack_params`` with its stacked grouped
expert payloads -- so both packages compute the same function: one
``paged_step`` must give the same logits on the live rows, and the
continuous engine the same greedy tokens.  The reference runs its default
CPU backend (XLA), except under the int8 policy with packed weights, where
it runs ``gemm_backend("interpret")``: its XLA backend re-quantizes an
unpacked payload per tensor, so parity with the packed kernel holds only on
its kernel path (as in ``test_torch_serve_packed.py``).

Tolerances: fp32 logits atol = rtol = 1e-4 (summation order only).  bf16
and int8 logits atol = rtol = 3e-2, as ``test_torch_serve.py`` reasons:
every GEMM output and the residual stream are rounded to bf16 in both, the
reference's attention oracle rounds the softmax weights to bf16 where the
port keeps f32, and a bf16 ulp at the logits' scale (about 1) is 2**-8.
Idle rows are excluded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.packing import pack_params as jpack_params  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.mpgemm import (  # noqa: E402
    mpgemm, mpgemm_grouped, mpgemm_packed, mpgemm_packed_grouped,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "granite-moe-1b-a400m"
TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2),
       "int8": dict(atol=3e-2, rtol=3e-2)}
EXPERTS = ("w_gate", "w_up", "w_down")


def _pair(policy, pack_format=None, pack=False, seed=0):
    jc, tc = jcb.get(ARCH, smoke=True), tcb.get(ARCH, smoke=True)
    jm = jbuild(jc, policy=policy, remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    if pack:
        jp = jpack_params(jp, policy=policy, pack_format=pack_format)
    tm = tbuild(tc, policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tc))
    return jm, jp, tm, tp


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
    assert got.shape == want.shape == (b, tm.vocab_padded)
    return got.float().numpy(), want, n_valid > 0


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_moe_paged_step_matches_reference(policy):
    jm, jp, tm, tp = _pair(policy)
    counts = (mpgemm.launches, mpgemm_grouped.launches)
    got, want, live = _step_both(jm, jp, tm, tp)
    np.testing.assert_allclose(got[live], want[live], **TOL[policy])
    assert np.isfinite(got).all()
    assert (mpgemm.launches, mpgemm_grouped.launches) == counts


@pytest.mark.parametrize("policy,pack_format", [("bf16", "int4"),
                                                ("int8", None)])
def test_packed_moe_paged_step_matches_reference(policy, pack_format):
    """int4 expert payloads under bf16 (XLA reference), int8 payloads under
    the int8 policy (interpret reference)."""
    jm, jp, tm, tp = _pair(policy, pack_format, pack=True)
    layer = tp["layers"][0]
    for name in EXPERTS:
        lay = layer[name].layout
        assert lay.g == tm.cfg.n_experts
        assert lay.dtype == (pack_format or "int8")
    assert not isinstance(layer["router"], PackedOperand)
    backend = "interpret" if policy == "int8" else "xla"
    counts = (mpgemm_packed.launches, mpgemm_packed_grouped.launches)
    with jcfg.gemm_backend(backend):
        got, want, live = _step_both(jm, jp, tm, tp)
    np.testing.assert_allclose(got[live], want[live], **TOL[policy])
    assert np.isfinite(got).all()
    assert (mpgemm_packed.launches,
            mpgemm_packed_grouped.launches) == counts


def test_load_params_takes_top_level_expert_tensors():
    """An MoE layer keeps its router and expert stacks at the top level of
    its dict: the casts find them there, and the router stays f32."""
    _, _, tm, tp = _pair("bf16")
    layer = tp["layers"][1]
    assert layer["router"].dtype == torch.float32
    for name in EXPERTS:
        assert layer[name].dtype == torch.bfloat16
        assert layer[name].shape[0] == tm.cfg.n_experts
    assert layer["attn"]["wq"].dtype == torch.bfloat16
    assert layer["ln2"]["scale"].dtype == torch.float32
    own = tm.init(torch.Generator().manual_seed(0))
    assert own["layers"][0]["router"].dtype == torch.float32
    assert own["layers"][0]["w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("policy", ["bf16", "int8"])
def test_params_from_jax_keeps_the_group_axis_of_packed_experts(policy):
    """The reference stacks grouped payloads per layer, (n_units, G, nkb,
    nnb, tk, bn): each layer's slice is a grouped operand of G groups with
    the reference's bytes."""
    jm, jp, tm, tp = _pair(policy, pack=True)
    g = tm.cfg.n_experts
    for u, layer in enumerate(tp["layers"]):
        for name in EXPERTS:
            got, want = layer[name], jp["stack"][0][name]
            assert got.layout.g == g
            assert tuple(got.payload.shape) == got.layout.payload_shape
            assert tuple(got.payload.shape) == \
                tuple(np.asarray(want.payload).shape[1:])
            assert got.payload.view(torch.uint8).numpy().tobytes() == \
                np.ascontiguousarray(np.asarray(want.payload)[u]).view(
                    np.uint8).tobytes()
            assert (got.scales is None) == (policy == "bf16")
            if got.scales is not None:
                np.testing.assert_array_equal(got.scales.numpy(),
                                              np.asarray(want.scales)[u])


def test_engine_greedy_tokens_match_reference():
    """Three requests through two slots (fp32): the same greedy tokens."""
    jm, jp, tm, tp = _pair("fp32")
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


def test_cli_serves_granite_on_cpu(capsys):
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
            "--max-new", "4"]
    outs = []
    for extra in ([], ["--pack"], ["--pack", "--pack-format", "int4"]):
        assert tserve.main(base + extra) == 0
        outs.append(capsys.readouterr().out)
    tokens = [[ln for ln in o.splitlines() if ln.startswith("  req")]
              for o in outs]
    assert "granite-moe-smoke on cpu: 2 requests, 8 tokens" in outs[0]
    assert tokens[1] == tokens[0]          # a bf16 payload is layout only
    assert "format=int4" in outs[2] and len(tokens[2]) == 2
