"""Parity of the port's ``quant_in`` (per-token activation quantization:
``mp_dot(..., quant_in=True)`` and ``mp_dot_grouped``) with the JAX
package's.

The port runs on CPU tensors (the plain versions of K1, K2 and K3); the
reference runs on ``backend="interpret"``, as ``tests/test_quant.py`` runs
it, which reaches the Pallas bodies with the ``quant_in`` tails.  Inputs
are drawn with numpy from a seed; both packages pack and sparsify the same
f32 weight with the same blocks and keep-masks.

Tolerances: the int8 rows, the int32 sums and the row scales are the same
in both (the scale up to one f32 ulp, see
``test_row_scales_follow_ieee_division``), so what differs is the order of
the f32 sums.  fp32 outputs: atol = rtol = 1e-5 of the output's range;
bf16 outputs: atol = rtol = 1.6e-2 (one bf16 ulp, 2**-8 relative, at |y|
up to 4).  Gradients (straight-through, the float GEMM's): fp32 1e-4,
bf16 1.6e-2, as ``tests/test_torch_gemm_bwd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro.core.gemm_spec import EpilogueSpec as JaxEpilogueSpec  # noqa: E402
from repro.core.gemm_spec import _quant_pre as jax_quant_pre  # noqa: E402
from repro.packing import pack_operand as jax_pack  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.core.gemm import mp_dot, mp_dot_grouped  # noqa: E402
from repro_torch.core.gemm_spec import EpilogueSpec, _quant_pre  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.packing.pack import pack_operand  # noqa: E402

G, M, K, N = 3, 6, 100, 72
BLOCKS = (32, 16)
OUT_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
           "bf16": dict(atol=1.6e-2, rtol=1.6e-2)}
GRAD_TOL = {"fp32": dict(atol=1e-4, rtol=1e-4),
            "bf16": dict(atol=1.6e-2, rtol=1.6e-2)}
X_DT = {"fp32": (np.float32, torch.float32),
        "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}

# (weight form, payload) -> the kernel the port's quant_in reaches.
WEIGHTS = {
    "dense": None,                       # K1 int8 x int8, scale sw
    "packed_int8": "int8",               # K2 int8 x int8 tiles
    "packed_int4": "int4",               # K2 int8 x int4 tiles
    "packed_fp8": "fp8e4m3",             # K2 int8 x fp8 tiles (f32)
    "packed_bf16": "bfloat16",           # K2, int8 rows upcast to bf16
    "sparse_int8": "int8",               # K3 int8 x int8 tiles
    "sparse_bf16": "bfloat16",           # K3, int8 rows upcast to bf16
}


def _draw(rng, shape, scale=1.0, bf16=False):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _keep(rng, lattice):
    keep = rng.random(lattice) < 0.5
    keep[..., 1] = False                          # an empty column tile
    keep[..., -1, -1] = True                      # the K-tail tile
    return keep


def _weights(form, w, rng):
    """The same weight for both packages: dense, packed or tile-sparse."""
    payload = WEIGHTS[form]
    if form == "dense":
        return jnp.asarray(w), torch.from_numpy(w)
    if form.startswith("packed"):
        return (jax_pack(jnp.asarray(w), BLOCKS, dtype=payload,
                         backend="xla"),
                pack_operand(torch.from_numpy(w), BLOCKS, dtype=payload))
    lattice = w.shape[:-2] + (-(-w.shape[-2] // BLOCKS[0]),
                              -(-w.shape[-1] // BLOCKS[1]))
    keep = _keep(rng, lattice)
    return (js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep,
                                  dtype=payload),
            ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                                  dtype=payload))


def _launches():
    return (tk.mpgemm.launches, tk.mpgemm_grouped.launches,
            tk.mpgemm_packed.launches, tk.mpgemm_packed_grouped.launches,
            tk.mpgemm_sparse.launches, tk.mpgemm_sparse_grouped.launches)


def _check(got, want, policy):
    want = np.asarray(want).astype(np.float32)
    tol = OUT_TOL[policy]
    scale = max(1.0, float(np.abs(want).max())) if policy == "fp32" else 1.0
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               **tol)


@pytest.mark.parametrize("tail", ["plain", "silu", "residual",
                                  "gelu_residual"])
@pytest.mark.parametrize("form", sorted(WEIGHTS))
def test_quant_in_2d_matches_reference(form, tail):
    policy = "bf16"
    rng = np.random.default_rng(sorted(WEIGHTS).index(form))
    x = _draw(rng, (M, K), bf16=True)
    w = _draw(rng, (K, N), 0.1)
    wj, wt = _weights(form, w, rng)
    kw_j, kw_t = {}, {}
    if tail in ("silu", "gelu_residual"):
        kw_j["activation"] = kw_t["activation"] = tail.split("_")[0]
    if tail.endswith("residual"):
        r = _draw(rng, (M, N), bf16=True)
        kw_j["residual"] = jnp.asarray(r.astype(ml_dtypes.bfloat16))
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    want = jax_mp_dot(jnp.asarray(x.astype(ml_dtypes.bfloat16)), wj,
                      policy=policy, backend="interpret", quant_in=True,
                      **kw_j)
    before = _launches()
    got = mp_dot(torch.from_numpy(x).to(torch.bfloat16), wt, policy=policy,
                 quant_in=True, **kw_t)
    assert _launches() == before           # plain versions on the CPU
    assert got.dtype == torch.bfloat16
    _check(got, want, policy)


@pytest.mark.parametrize("form", ["dense", "packed_fp8", "sparse_int8"])
def test_quant_in_fp32_policy_matches_reference(form):
    rng = np.random.default_rng(30)
    x = _draw(rng, (M, K))
    w = _draw(rng, (K, N), 0.1)
    wj, wt = _weights(form, w, rng)
    want = jax_mp_dot(jnp.asarray(x), wj, policy="fp32", backend="interpret",
                      quant_in=True, activation="relu")
    got = mp_dot(torch.from_numpy(x), wt, policy="fp32", quant_in=True,
                 activation="relu")
    assert got.dtype == torch.float32
    _check(got, want, "fp32")


@pytest.mark.parametrize("form", ["dense", "packed_int8", "packed_fp8",
                                  "sparse_int8", "sparse_bf16"])
@pytest.mark.parametrize("tail", ["silu", "residual"])
def test_quant_in_grouped_matches_reference(form, tail):
    """``mp_dot_grouped(..., quant_in=True)``: rows quantized per group,
    (G, M, 1) row scales; the grouped variants of K1, K2 and K3."""
    policy = "bf16"
    rng = np.random.default_rng(40 + sorted(WEIGHTS).index(form))
    x = _draw(rng, (G, M, K), bf16=True)
    w = _draw(rng, (G, K, N), 0.1)
    wj, wt = _weights(form, w, rng)
    kw_j, kw_t = {}, {}
    if tail == "silu":
        kw_j["activation"] = kw_t["activation"] = "silu"
    else:
        r = _draw(rng, (G, M, N))
        kw_j["residual"], kw_t["residual"] = jnp.asarray(r), \
            torch.from_numpy(r)
        kw_j["out_dtype"], kw_t["out_dtype"] = jnp.float32, torch.float32
    want = jax_mp_dot_grouped(jnp.asarray(x.astype(ml_dtypes.bfloat16)), wj,
                              policy=policy, backend="interpret",
                              quant_in=True, **kw_j)
    got = mp_dot_grouped(torch.from_numpy(x).to(torch.bfloat16), wt,
                         policy=policy, quant_in=True, **kw_t)
    _check(got, want, policy)


def test_quant_in_refusals_match_reference():
    """quant_in takes no bias and no gate, and not an explicit epilogue
    too: ValueError in both packages."""
    x, w = np.ones((M, K), np.float32), np.ones((K, N), np.float32)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    bias = np.zeros(N, np.float32)
    gate = np.ones((M, N), np.float32)
    for jkw, tkw in (
            (dict(b=None, bias=jnp.asarray(bias)),
             dict(bias=torch.from_numpy(bias))),
            (dict(gate=jnp.asarray(gate)), dict(gate=torch.from_numpy(gate))),
            (dict(epilogue=JaxEpilogueSpec()), dict(epilogue=EpilogueSpec()))):
        jkw = {k: v for k, v in jkw.items() if k != "b"}
        with pytest.raises(ValueError):
            jax_mp_dot(xj, wj, policy="fp32", backend="interpret",
                       quant_in=True, **jkw)
        with pytest.raises(ValueError):
            mp_dot(xt, wt, policy="fp32", quant_in=True, **tkw)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("tail", ["plain", "silu_residual"])
@pytest.mark.parametrize("grouped", [False, True])
def test_quant_in_grads_are_straight_through(policy, tail, grouped):
    """The backward ignores the rounding: the float GEMM's gradients (dx,
    dW and the residual's), against ``jax.grad`` on ``interpret``."""
    rng = np.random.default_rng(50)
    np_dt, t_dt = X_DT[policy]
    lead = (G, M) if grouped else (M,)
    x = _draw(rng, (*lead, K), bf16=policy == "bf16")
    w = _draw(rng, ((G,) if grouped else ()) + (K, N), 0.1,
              bf16=policy == "bf16")
    r = _draw(rng, (*lead, N), bf16=policy == "bf16")
    dy = rng.standard_normal((*lead, N)).astype(np.float32)
    jop, top = (jax_mp_dot_grouped, mp_dot_grouped) if grouped else \
        (jax_mp_dot, mp_dot)
    act = "silu" if tail != "plain" else None
    use_r = tail != "plain"

    def jloss(xx, ww, rr):
        y = jop(xx, ww, policy=policy, backend="interpret", quant_in=True,
                activation=act, residual=rr if use_r else None)
        return jnp.sum(y.astype(jnp.float32) * dy)

    prim_j = [jnp.asarray(a.astype(np_dt)) for a in (x, w, r)]
    want = jax.grad(jloss, argnums=(0, 1, 2) if use_r else (0, 1))(*prim_j)
    prim_t = [torch.from_numpy(a).to(t_dt).requires_grad_(True)
              for a in (x, w, r)]
    y = top(prim_t[0], prim_t[1], policy=policy, quant_in=True,
            activation=act, residual=prim_t[2] if use_r else None)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    for name, t, wj in zip(("dx", "dw", "dresidual"), prim_t, want):
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(wj).astype(np.float32),
                                   err_msg=name, **GRAD_TOL[policy])


def test_row_scales_follow_ieee_division():
    """The port's pre-stage divides by 127 in IEEE f32 (as its per-tensor
    quantizer and its packer do).  The reference's eager pre-stage gives
    the same bits; compiled under ``jax.jit``, XLA multiplies by the
    reciprocal of 127 instead, and its row scale may then differ by one
    f32 ulp (129 of 3,200 rows over numpy seeds 0-49, (64, 300) f32 rows
    of ranges 0.01-10); the int8 rows agreed in every element tested."""
    spec_j, spec_t = JaxEpilogueSpec(kind="quant_in"), \
        EpilogueSpec(kind="quant_in")
    jitted = jax.jit(lambda x: jax_quant_pre(spec_j, x))
    off_by_one = 0
    for seed in range(8):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal((64, 300))
             * rng.uniform(0.01, 10, (64, 1))).astype(np.float32)
        ieee = (np.maximum(np.abs(x).max(-1, keepdims=True),
                           np.float32(1e-8)) / np.float32(127))
        qt, (st,) = _quant_pre(spec_t, torch.from_numpy(x))
        qj, (sj,) = jax_quant_pre(spec_j, jnp.asarray(x))
        qc, (sc,) = jitted(jnp.asarray(x))
        np.testing.assert_array_equal(st.numpy(), ieee)
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
        ulps = np.abs(np.asarray(sc).view(np.int32)
                      - st.numpy().view(np.int32))
        assert ulps.max() <= 1
        off_by_one += int(ulps.sum())
        assert np.abs(np.asarray(qc).astype(int)
                      - qt.numpy().astype(int)).max() <= 1
    assert off_by_one < 64 * 8
