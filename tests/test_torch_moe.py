"""The port's MoE block (``repro_torch.models.blocks.moe_mlp``) against the
JAX package's, on the CPU, at ``granite-moe-smoke`` and ``mixtral-smoke``
widths.

The reference draws its parameters (``init_moe``) and both packages get
them, and the same input rows, through numpy.  The JAX side runs its
default CPU backend (XLA), or its interpret kernels for packed experts.
Capacity 1.25 makes experts overflow, so the newest-token-first slot order
(a stable sort in both packages) decides which (token, choice) pairs are
dropped; capacity 4.0 is the serving setting.  The routing is compared
for equality: the top-k experts against ``jax.lax.top_k`` on the
reference's gates, and the slot assignment against a plain loop that fills
each expert's slots from the last token back.

Tolerances: f32 outputs atol = rtol = 1e-5 (summation order only, in the
router, the expert GEMMs and the combine; the int8 policy's int32 sums are
exact in both).  bf16 outputs atol = rtol =
1.6e-2: the expert GEMMs read bf16 operands in both and sum in f32, the
f32 hidden activations are rounded to bf16 before the down projection and
the output is rounded to bf16, so a different summation order can move an
element across one bf16 rounding (2**-8 relative) on the way.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core.gemm import mp_dot  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2)}
ARCHS = {"granite": "granite-moe-1b-a400m", "mixtral": "mixtral-8x22b"}
B, S = 2, 16


def _cfgs(arch):
    j = jcb.get(ARCHS[arch], smoke=True)
    t = tcb.ArchConfig(**{f.name: getattr(j, f.name)
                          for f in dataclasses.fields(tcb.ArchConfig)})
    return j, t


def _params(jcfg, seed=0):
    jp = jblocks.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32).copy())
          for k, v in jp.items() if not isinstance(v, dict)}
    return jp, tp


def _x(cfg, policy, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    if policy == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(x), torch.from_numpy(
            x.view(np.uint16).copy()).view(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def _dispatch_loop(topi, e, cap):
    """Slots filled from the last token back, each token's choices in
    order, the first ``cap`` pairs of an expert kept."""
    b, s, k = topi.shape
    src = np.full((b, e * cap), s)
    dest = np.full((b, s, k), e * cap)
    for bi in range(b):
        fill = [0] * e
        for t in reversed(range(s)):
            for j in range(k):
                ex = topi[bi, t, j]
                if fill[ex] < cap:
                    src[bi, ex * cap + fill[ex]] = t
                    dest[bi, t, j] = ex * cap + fill[ex]
                    fill[ex] += 1
    return src, dest.reshape(b, s * k)


@pytest.mark.parametrize("capacity", [1.25, 4.0])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_routing_matches_reference(arch, capacity):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    xj, xt = _x(tcfg, "fp32")
    e, k = tcfg.n_experts, tcfg.experts_per_token
    want_gates = jax.nn.softmax(
        jax_mp_dot(xj, jp["router"], policy="fp32").astype(jnp.float32), -1)
    _, want_topi = jax.lax.top_k(want_gates, k)
    gates = torch.softmax(mp_dot(xt, tp["router"], policy="fp32").float(),
                          dim=-1)
    topw, topi = tblocks.moe_topk(gates, k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want_topi))
    np.testing.assert_allclose(topw.numpy(),
                               np.asarray(jax.lax.top_k(want_gates, k)[0]),
                               atol=1e-6, rtol=1e-6)
    cap = tblocks.moe_capacity(capacity, k, S, e)
    assert cap == max(1, int(round(capacity * k * S / e)))
    src, dest = tblocks.moe_dispatch(topi, e, cap)
    want_src, want_dest = _dispatch_loop(topi.numpy(), e, cap)
    np.testing.assert_array_equal(src.numpy(), want_src)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    dropped = int((dest == e * cap).sum())
    if capacity == 4.0:
        assert dropped == 0                    # dropless at serve capacity
    else:
        assert dropped > 0                     # the overflow path runs


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("capacity", [1.25, 4.0])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moe_mlp_matches_reference(arch, capacity, policy):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    xj, xt = _x(tcfg, policy)
    want, _ = jblocks.moe_mlp(jp, xj, jcfg, policy, capacity_factor=capacity)
    got = tblocks.moe_mlp(tp, xt, tcfg, policy, capacity_factor=capacity)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[policy])


def test_topk_breaks_ties_as_lax_top_k():
    """Equal gates go lower expert first, as ``jax.lax.top_k`` orders
    them (``torch.topk`` does not promise an order for ties)."""
    rng = np.random.default_rng(3)
    gates = rng.integers(0, 3, (64, 8)).astype(np.float32)
    gates[0] = 0.125                                   # all equal
    for k in (1, 2, 4, 8):
        w, i = tblocks.moe_topk(torch.from_numpy(gates), k)
        wj, ij = jax.lax.top_k(jnp.asarray(gates), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(w.numpy(), np.asarray(wj))


@pytest.mark.parametrize("policy,packed", [("fp32", False), ("int8", False),
                                           ("int8", True)])
def test_moe_mlp_one_token_rows_match_reference(policy, packed):
    """Decode rows (s = 1) at one slot per expert: the (E, b, d) expert
    buffer is then a strided view, which the GEMMs (and under int8 the
    quantized copy of it) must take as they take a contiguous one."""
    from repro.core import config as jcfg
    from repro.packing import pack as jpack
    from repro_torch.packing import pack as tpack

    jcfg_, tcfg = _cfgs("granite")
    jp, tp = _params(jcfg_)
    if packed:
        for name in ("w_gate", "w_up", "w_down"):
            jp[name] = jpack.pack_operand(jp[name], (64, 32), dtype="int8",
                                          backend="xla")
            tp[name] = tpack.pack_operand(tp[name], (64, 32), dtype="int8")
    x = np.random.default_rng(2).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32)
    assert tblocks.moe_capacity(1.0, tcfg.experts_per_token, 1,
                                tcfg.n_experts) == 1
    with jcfg.gemm_backend("interpret" if packed else "xla"):
        want, _ = jblocks.moe_mlp(jp, jnp.asarray(x), jcfg_, policy,
                                  capacity_factor=1.0)
    got = tblocks.moe_mlp(tp, torch.from_numpy(x), tcfg, policy,
                          capacity_factor=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["fp32"])
