"""Parity of the PyTorch port's ``mp_dot`` with the JAX package's.

The port runs on CPU tensors, so its K1 wrapper takes the plain version;
the JAX side runs under ``gemm_backend("interpret")``, which reaches the
Pallas K1 body (``make_gemm_kernel.kernel``) in interpret mode.  Inputs are
drawn with numpy from a seed and rounded to bf16 through ``ml_dtypes`` where
the policy computes in bf16, so both packages see the same bits.

Tolerances: fp32 atol = rtol = 1e-5 (the two sum the K products in another
order).  bf16 is compared in f32 with atol = rtol = 1.6e-2: both round the
f32 epilogue result to a bf16 output, and a different summation order can
put the two results on either side of a rounding boundary (one bf16 ulp is
2**-8 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core import gemm_spec as jspec  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro_torch.core import gemm_spec as tspec  # noqa: E402
from repro_torch.core.gemm import mp_dot  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels.mpgemm import mpgemm  # noqa: E402

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2)}

# (lead shape of x, K, N, options).  K = 300 is not a multiple of the plan's
# bk (384, so the one K block is partly masked); K = 2100 runs two K steps
# of bk = 2048 with a 52-wide tail.  M = 37 and N = 100 are off every tile.
CASES = {
    "linear": ((2, 12), 96, 136, {}),
    "gated_silu": ((24,), 96, 136, dict(activation="silu", gate=True)),
    "residual": ((24,), 96, 136, dict(residual=True)),
    "bias_gelu_tanh": ((24,), 96, 136, dict(activation="gelu", bias=True)),
    "trans_w": ((24,), 96, 136, dict(trans_w=True)),
    "mn_edges_k_tail": ((37,), 300, 100, dict(activation="relu")),
    "multi_block_k_tail": ((8,), 2100, 128, dict(residual=True)),
}


def _draw(rng, shape, policy, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if policy == "bf16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mp_dot_matches_interpret_kernel(case, policy):
    lead, k, n, opt = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = _draw(rng, (*lead, k), policy)
    wshape = (n, k) if opt.get("trans_w") else (k, n)
    w = _draw(rng, wshape, policy, scale=(2.0 / (k + n)) ** 0.5)
    out_np = np.float32 if policy == "fp32" else ml_dtypes.bfloat16
    out_t = torch.float32 if policy == "fp32" else torch.bfloat16
    named = {}
    if opt.get("bias"):
        named["bias"] = rng.standard_normal(n).astype(np.float32)
    for nm in ("gate", "residual"):
        if opt.get(nm):
            named[nm] = _draw(rng, (*lead, n), policy)
    kw = dict(policy=policy, trans_w=opt.get("trans_w", False),
              activation=opt.get("activation"))

    with jcfg.gemm_backend("interpret"):
        want = jax_mp_dot(
            jnp.asarray(x), jnp.asarray(w),
            **{nm: jnp.asarray(v.astype(out_np) if nm != "bias" else v)
               for nm, v in named.items()}, **kw)
    got = mp_dot(torch.from_numpy(x), torch.from_numpy(w),
                 **{nm: torch.from_numpy(v).to(out_t if nm != "bias"
                                               else torch.float32)
                    for nm, v in named.items()}, **kw)

    assert got.dtype == out_t and tuple(got.shape) == (*lead, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[policy])


def test_apply_epilogue_order_matches_reference():
    """scale, then alpha, then bias, then the tail, then beta·C — the same
    order as the reference's single epilogue implementation."""
    rng = np.random.default_rng(7)
    acc, bias, c, r = (rng.standard_normal(s).astype(np.float32)
                       for s in ((6, 10), (1, 10), (6, 10), (6, 10)))
    for act in (None, "relu", "silu", "gelu"):
        jep = jspec.EpilogueSpec(kind="residual", activation=act, alpha=0.5,
                                 beta=2.0)
        tep = tspec.EpilogueSpec(kind="residual", activation=act, alpha=0.5,
                                 beta=2.0)
        want = jspec.apply_epilogue(jep, jnp.asarray(acc),
                                    bias=jnp.asarray(bias), scale=3.0,
                                    c=jnp.asarray(c),
                                    extras=(jnp.asarray(r),))
        got = tspec.apply_epilogue(tep, torch.from_numpy(acc),
                                   bias=torch.from_numpy(bias), scale=3.0,
                                   c=torch.from_numpy(c),
                                   extras=(torch.from_numpy(r),))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=str(act))


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; torch's default is the erf form."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tspec.ACTIVATIONS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("variant", ["trans_a", "beta_c", "packed",
                                     "quant_in", "int8_policy"])
def test_formerly_unported_variants_match_reference(variant):
    """The variants the kernels once refused, now ported and held against
    the reference on the CPU: ``trans_a`` (A read as (K, M)) together with
    ``trans_b``, ``beta_c`` (beta·C on K1), ``packed`` (beta·C against a
    packed operand, K2), ``quant_in`` (per-token activation quantization)
    and ``int8_policy`` (int8 operands under ``trans_a``, an exact int32
    output: equal).  The reference runs its interpret kernels; f32 outputs
    within atol = rtol = 1e-5 (summation order)."""
    from repro.kernels import ops as jops
    from repro.packing import pack_operand as jax_pack
    from repro_torch.packing.pack import pack_operand

    rng = np.random.default_rng(["trans_a", "beta_c", "packed", "quant_in",
                                 "int8_policy"].index(variant))
    a, b = _draw(rng, (4, 8), "fp32"), _draw(rng, (8, 16), "fp32")
    c = _draw(rng, (4, 16), "fp32")
    j, t = jnp.asarray, torch.from_numpy
    if variant == "trans_a":
        want = jops.mpgemm(j(a.T.copy()), j(b.T.copy()), trans_a=True,
                           trans_b=True, interpret=True)
        got = mpgemm(t(a.T.copy()), t(b.T.copy()),
                     spec=tspec.GemmSpec(trans_a=True, trans_b=True))
    elif variant == "beta_c":
        want = jops.mpgemm(j(a), j(b), j(c), beta=1.0, interpret=True)
        got = mpgemm(t(a), t(b), c=t(c),
                     epilogue=tspec.EpilogueSpec(beta=1.0))
    elif variant == "packed":
        want = jops.mpgemm(j(a), jax_pack(j(b), (8, 8), dtype="float32",
                                          backend="xla"), j(c), beta=1.0,
                           interpret=True)
        got = mpgemm(t(a), pack_operand(t(b), (8, 8), dtype="float32"),
                     c=t(c), epilogue=tspec.EpilogueSpec(beta=1.0))
    elif variant == "quant_in":
        with jcfg.gemm_backend("interpret"):
            want = jax_mp_dot(j(a), j(b), policy="fp32", quant_in=True)
        got = mp_dot(t(a), t(b), policy="fp32", quant_in=True)
    else:
        ai = rng.integers(-127, 128, (8, 4)).astype(np.int8)
        bi = rng.integers(-127, 128, (8, 16)).astype(np.int8)
        want = jops.mpgemm(j(ai), j(bi), trans_a=True, interpret=True)
        got = mpgemm(t(ai), t(bi), spec=tspec.GemmSpec(trans_a=True))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["fp32"])


def test_scale_rides_the_epilogue_before_alpha():
    """The scalar dequant scale (the int8 policy's sx · sw) multiplies the
    accumulator first, as in the reference's apply_epilogue."""
    a = torch.randint(-5, 6, (3, 8), dtype=torch.int8)
    b = torch.randint(-5, 6, (8, 4), dtype=torch.int8)
    ep = tspec.EpilogueSpec(alpha=0.5, activation="relu")
    got = mpgemm(a, b, scale=torch.tensor(0.25), bias=torch.ones(4),
                 epilogue=ep, out_dtype=torch.float32)
    want = torch.relu((a.int() @ b.int()).float() * 0.25 * 0.5 + 1.0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert get_policy("int8").quantized
