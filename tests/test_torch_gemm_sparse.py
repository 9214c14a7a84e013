"""Parity of the port's tile-sparse ``mp_dot`` / ``mp_dot_grouped`` with the
JAX package's.

The port runs on CPU tensors, so its K3 wrappers take the plain version
(``mpgemm_sparse_plain``: one product per stored tile, ``index_add`` into
the output columns, the epilogue).  The JAX side runs under
``gemm_backend("interpret")``, which reaches the Pallas tile-sparse body
(``make_gemm_kernel.sparse_kernel`` over the stored-tile schedule, anchor
visits included) in interpret mode.  Inputs are drawn with numpy from a
seed and rounded to bf16 through ``ml_dtypes`` where the policy computes
in bf16, so both packages see the same bits; each package sparsifies the
same f32 weight with the same keep-mask (byte-identical operands:
``test_torch_sparse.py``).

Shapes: K = 300 over bk = 128 gives a 44-row K tail, N = 200 over bn = 64
an 8-column N tail; every mask leaves column tile 1 empty, so its outputs
are the epilogue of a zero sum (bias, activation, gate, residual).

Tolerances, by output dtype: f32 outputs atol = rtol = 1e-5 (the f32 sums
run in another order); bf16 outputs (the bf16 and int8 policies) atol =
rtol = 1.6e-2, one bf16 ulp (2**-8) at |y| up to 4, since a different
summation order can put the f32 result on the other side of a bf16
rounding.  Under int8 the per-tile int32 partials are exact in both, and
the f32 sum of the scaled partials runs in the reference's visit order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.core.gemm_spec import GemmSpec  # noqa: E402
from repro_torch.core.gemm import mp_dot, mp_dot_grouped  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1.6e-2, rtol=1.6e-2)}
PAYLOAD = {"fp32": "float32", "bf16": "bfloat16", "int8": "int8"}
OUT = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.bfloat16}
M, K, N, BLOCKS = 5, 300, 200, (128, 64)


def _draw(rng, shape, bf16, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _keep(rng, lattice, mask):
    keep = rng.random(lattice) < 0.5
    keep[..., 1] = False                         # an empty column tile
    keep[..., -1, -1] = True                     # the K- and N-tail tile
    if mask == "empty":
        keep[...] = False                        # a fully empty operand
    return keep


def _operands(w, keep, payload, trans_w=False):
    wj = js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep, trans_w=trans_w,
                               dtype=payload)
    wt = ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                               trans_w=trans_w, dtype=payload)
    return wj, wt


def _named(rng, opt, shape, bf16, out_t):
    named = {nm: _draw(rng, shape, bf16) for nm in ("gate", "residual")
             if opt.get(nm)}
    out_np = ml_dtypes.bfloat16 if out_t == torch.bfloat16 else np.float32
    return ({nm: jnp.asarray(v.astype(out_np)) for nm, v in named.items()},
            {nm: torch.from_numpy(v).to(out_t) for nm, v in named.items()})


def _count():
    return (tk.mpgemm.launches, tk.mpgemm_sparse.launches,
            tk.mpgemm_sparse_grouped.launches)


EPILOGUES = {
    "linear_bias": dict(bias=True),
    "gated_silu_bias": dict(bias=True, gate=True, activation="silu"),
    "residual_relu_bias": dict(bias=True, residual=True, activation="relu"),
    "linear": {},
}


@pytest.mark.parametrize("mask", ["half", "empty"])
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
def test_sparse_mp_dot_matches_interpret_kernel(policy, epilogue, mask):
    opt = EPILOGUES[epilogue]
    rng = np.random.default_rng(1)
    bf16, out_t = policy != "fp32", OUT[policy]
    x = _draw(rng, (M, K), bf16)
    w = _draw(rng, (K, N), False, scale=(2.0 / (K + N)) ** 0.5)
    bias = rng.standard_normal(N).astype(np.float32) if opt.get("bias") \
        else None
    named_j, named_t = _named(rng, opt, (M, N), bf16, out_t)
    wj, wt = _operands(w, _keep(rng, (3, 4), mask), PAYLOAD[policy])
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(jnp.asarray(x), wj,
                          None if bias is None else jnp.asarray(bias),
                          policy=policy, activation=opt.get("activation"),
                          **named_j)
    before = _count()
    got = mp_dot(torch.from_numpy(x), wt,
                 None if bias is None else torch.from_numpy(bias),
                 policy=policy, activation=opt.get("activation"), **named_t)
    assert _count() == before                  # the plain version on the CPU
    assert got.dtype == out_t and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want).astype(np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[out_t])
    # The empty column tile is the epilogue of a zero sum.
    if epilogue == "linear_bias":
        np.testing.assert_allclose(got[:, 64:128].float().numpy(),
                                   np.broadcast_to(bias[64:128], (M, 64)),
                                   **TOL[out_t])


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
def test_sparse_trans_w_head_matches_interpret_kernel(policy):
    """A head sparsified from its (N, K) orientation: the transpose is
    resolved at sparsify time and ``trans_w`` must match it."""
    rng = np.random.default_rng(2)
    x = _draw(rng, (3, 2, K), policy != "fp32")
    w = _draw(rng, (N, K), False, scale=0.05)
    wj, wt = _operands(w, _keep(rng, (3, 4), "half"), PAYLOAD[policy],
                       trans_w=True)
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(jnp.asarray(x), wj, policy=policy, trans_w=True)
    got = mp_dot(torch.from_numpy(x), wt, policy=policy, trans_w=True)
    assert tuple(got.shape) == (3, 2, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[OUT[policy]])
    with pytest.raises(ValueError, match="trans_w"):
        mp_dot(torch.from_numpy(x), wt, policy=policy)


def test_float_payload_under_int8_is_densified():
    """A bf16 payload under the int8 policy: densify (zeros at the pruned
    tiles), then the dense int8 path -- x and the weight quantized per
    tensor, K1's int8 variant -- as in the reference."""
    rng = np.random.default_rng(3)
    x = _draw(rng, (M, K), True)
    w = _draw(rng, (K, N), False, scale=0.07)
    wj, wt = _operands(w, _keep(rng, (3, 4), "half"), "bfloat16")
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(jnp.asarray(x), wj, policy="int8",
                          activation="gelu")
    k1, k3, k3g = _count()
    got = mp_dot(torch.from_numpy(x), wt, policy="int8", activation="gelu")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[torch.bfloat16])
    assert _count() == (k1, k3, k3g)


def test_int8_payload_under_a_float_policy_matches_reference():
    """A float A against an int8 payload, once refused, is now K3's float x
    int8 variant: each tile dequantized by its scale and rounded to A's
    dtype (bf16) before an f32 sum, as the reference's ``_accumulate``.
    ``mp_dot`` under bf16 and the K3 wrapper alike, against the
    reference's interpret kernel (bf16 outputs, 1.6e-2)."""
    rng = np.random.default_rng(4)
    x = _draw(rng, (M, K), True)
    w = _draw(rng, (K, N), False)
    wj, wt = _operands(w, _keep(rng, (3, 4), "half"), "int8")
    xj = jnp.asarray(x.astype(ml_dtypes.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(xj, wj, policy="bf16", activation="silu")
    got = mp_dot(xt, wt, policy="bf16", activation="silu")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[torch.bfloat16])
    got = tk.mpgemm_sparse(xt, wt, out_dtype=torch.bfloat16)
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(xj, wj, policy="bf16")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[torch.bfloat16])


def test_mpgemm_dispatches_a_sparse_operand_to_k3(monkeypatch):
    calls = []
    real = tk.mpgemm_sparse

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tk, "mpgemm_sparse", spy)
    w = torch.from_numpy(_draw(np.random.default_rng(5), (K, N), False))
    wt = ts.sparsify_magnitude(w, BLOCKS, density=0.5)
    out = tk.mpgemm(torch.ones(M, K), wt)
    assert calls == [1] and out.shape == (M, N)
    with pytest.raises(ValueError, match="transpose"):
        tk.mpgemm(torch.ones(M, K), wt, spec=GemmSpec(trans_b=True))
    with pytest.raises(ValueError, match="TileSparseOperand"):
        tk.mpgemm(torch.ones(M, K), w, spec=GemmSpec(sparse=True))


# --- grouped -----------------------------------------------------------------

# (G, M, K, N, options); N = 100 and 136 over bn = 64 leave 36- and
# 8-column tails.
GROUPED = {
    "g3_bias_gn_relu": (3, 7, 300, 100, dict(bias="gn", activation="relu")),
    "g4_gated_silu_f32_out": (4, 4, 300, 100,
                              dict(gate=True, activation="silu",
                                   out=torch.float32)),
    "g3_residual_bias_n": (3, 9, 130, 136, dict(residual=True, bias="n")),
    "g4_group_sizes_f32_out": (4, 6, 300, 100,
                               dict(group_sizes=True, out=torch.float32)),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
def test_sparse_mp_dot_grouped_matches_interpret_kernel(policy, case):
    g, m, k, n, opt = GROUPED[case]
    rng = np.random.default_rng(6)
    bf16 = policy != "fp32"
    out_t = opt.get("out", OUT[policy])
    x = _draw(rng, (g, m, k), bf16)
    w = _draw(rng, (g, k, n), False, scale=(2.0 / (k + n)) ** 0.5)
    bias = None
    if opt.get("bias"):
        bias = rng.standard_normal((g, n) if opt["bias"] == "gn"
                                   else (n,)).astype(np.float32)
    named_j, named_t = _named(rng, opt, (g, m, n), bf16, out_t)
    lattice = (g, -(-k // BLOCKS[0]), -(-n // BLOCKS[1]))
    wj, wt = _operands(w, _keep(rng, lattice, "half"), PAYLOAD[policy])
    sizes = np.array([m, 0, m - 3, 1][:g], np.int32) \
        if opt.get("group_sizes") else None
    kw_j = dict(policy=policy, activation=opt.get("activation"), **named_j)
    kw_t = dict(policy=policy, activation=opt.get("activation"), **named_t)
    if "out" in opt:
        kw_j["out_dtype"] = jnp.float32
        kw_t["out_dtype"] = torch.float32
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot_grouped(
            jnp.asarray(x), wj, None if bias is None else jnp.asarray(bias),
            group_sizes=None if sizes is None else jnp.asarray(sizes),
            **kw_j)
    before = _count()
    got = mp_dot_grouped(
        torch.from_numpy(x), wt,
        None if bias is None else torch.from_numpy(bias),
        group_sizes=None if sizes is None else torch.from_numpy(sizes),
        **kw_t)
    assert _count() == before
    assert got.dtype == out_t and tuple(got.shape) == (g, m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[out_t])
    if sizes is not None:
        assert (got[1] == 0).all() and (got[2, m - 3:] == 0).all()


def test_grouped_float_payload_under_int8_is_densified():
    rng = np.random.default_rng(7)
    g, m, k, n = 3, 4, 300, 100
    x = _draw(rng, (g, m, k), True)
    w = _draw(rng, (g, k, n), False, scale=0.07)
    wj, wt = _operands(w, _keep(rng, (g, 3, 2), "half"), "bfloat16")
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot_grouped(jnp.asarray(x), wj, policy="int8",
                                  out_dtype=jnp.float32)
    got = mp_dot_grouped(torch.from_numpy(x), wt, policy="int8",
                         out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL[torch.float32])


def test_group_count_is_checked():
    w = torch.from_numpy(_draw(np.random.default_rng(8), (3, K, N), False))
    wt = ts.sparsify_magnitude(w, BLOCKS, density=0.5)
    with pytest.raises(ValueError, match="group mismatch"):
        mp_dot_grouped(torch.ones(2, M, K), wt, policy="fp32")
    with pytest.raises(ValueError, match="mp_dot_grouped"):
        mp_dot(torch.ones(M, K), wt, policy="fp32")
    with pytest.raises(ValueError, match="group mismatch"):
        tk.mpgemm_sparse(torch.ones(M, K), wt)
