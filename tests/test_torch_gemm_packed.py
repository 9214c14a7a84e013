"""Parity of the port's packed and int8 ``mp_dot`` with the JAX package's.

The port runs on CPU tensors, so ``mpgemm`` takes K2's plain version for a
packed ``b`` and K1's plain int8 version for a dense one under the int8
policy.  The JAX side runs under ``gemm_backend("interpret")``, which
reaches the Pallas packed-B body (per-tile scale in ``_accumulate``, the
int4 ``unpack_nibbles`` decode) in interpret mode; the dense int8 case is
also held against the ``xla`` backend.  Inputs are drawn with numpy from a
seed and rounded to bf16 through ``ml_dtypes``, so both packages see the
same bits, and both pack the same f32 weight with the same blocks (the
payloads are byte-identical: ``test_torch_packing.py``).

Tolerances: bf16 outputs (the bf16 and int8 policies) atol = rtol =
1.6e-2, one bf16 ulp (2**-8) at |y| up to 4: the dequantized weights and
the int32 partials are the same in both, but the f32 sums run in another
order and the bf16 output rounding can land on either side.  fp32 outputs
atol = rtol = 1e-5 (summation order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.packing import pack as jpack  # noqa: E402
from repro_torch.core.gemm import mp_dot  # noqa: E402
from repro_torch.kernels.mpgemm import mpgemm, mpgemm_packed  # noqa: E402
from repro_torch.packing import pack as tpack  # noqa: E402

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2),
       "int8": dict(atol=1.6e-2, rtol=1.6e-2)}

# K = 300 over bk = 128 is three K tiles with a 44-row tail; N = 200 over
# bn = 64 is four column tiles, the last one ragged; M = 5.
M, K, N, BLOCKS = 5, 300, 200, (128, 64)
EPILOGUES = {"linear": {}, "gated_silu": dict(activation="silu", gate=True),
             "residual": dict(residual=True)}


def _draw(rng, shape, scale=1.0, bf16=True):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _inputs(seed, policy, opt, *, trans_w=False):
    rng = np.random.default_rng(seed)
    x = _draw(rng, (M, K), bf16=policy != "fp32")
    w = _draw(rng, (N, K) if trans_w else (K, N),
              scale=(2.0 / (K + N)) ** 0.5, bf16=False)
    named = {nm: _draw(rng, (M, N), bf16=policy != "fp32")
             for nm in ("gate", "residual") if opt.get(nm)}
    return x, w, named


def _run_both(x, w_j, w_t, named, policy, backend, **kw):
    out_np = np.float32 if policy == "fp32" else ml_dtypes.bfloat16
    out_t = torch.float32 if policy == "fp32" else torch.bfloat16
    with jcfg.gemm_backend(backend):
        want = jax_mp_dot(jnp.asarray(x), w_j, policy=policy,
                          **{nm: jnp.asarray(v.astype(out_np))
                             for nm, v in named.items()}, **kw)
    got = mp_dot(torch.from_numpy(x), w_t, policy=policy,
                 **{nm: torch.from_numpy(v).to(out_t)
                    for nm, v in named.items()}, **kw)
    assert got.dtype == out_t and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want).astype(np.float32)


@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
@pytest.mark.parametrize("policy", ["bf16", "int8"])
@pytest.mark.parametrize("payload", ["bfloat16", "int8", "int4", "fp8e4m3"])
def test_packed_mp_dot_matches_interpret_kernel(payload, policy, epilogue):
    opt = EPILOGUES[epilogue]
    x, w, named = _inputs(7, policy, opt)
    w_j = jpack.pack_operand(jnp.asarray(w), BLOCKS, dtype=payload,
                             backend="xla")
    w_t = tpack.pack_operand(torch.from_numpy(w), BLOCKS, dtype=payload)
    k2 = mpgemm_packed.launches
    got, want = _run_both(x, w_j, w_t, named, policy, "interpret",
                          activation=opt.get("activation"))
    np.testing.assert_allclose(got, want, **TOL[policy])
    assert mpgemm_packed.launches == k2          # plain version on the CPU


@pytest.mark.parametrize("payload", ["int8", "int4", "fp8e4m3"])
def test_packed_mp_dot_fp32_policy_matches_interpret_kernel(payload):
    """f32 A against a codec tile: the scaled tile is not rounded."""
    x, w, named = _inputs(11, "fp32", {"residual": True})
    w_j = jpack.pack_operand(jnp.asarray(w), BLOCKS, dtype=payload,
                             backend="xla")
    w_t = tpack.pack_operand(torch.from_numpy(w), BLOCKS, dtype=payload)
    got, want = _run_both(x, w_j, w_t, named, "fp32", "interpret")
    np.testing.assert_allclose(got, want, **TOL["fp32"])


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("case", ["linear", "gated_silu", "trans_w"])
def test_dense_int8_policy_matches_reference(case, backend):
    """Both operands quantized per tensor, an exact int32 sum, sx · sw in
    the epilogue's scale slot."""
    opt = EPILOGUES.get(case, {})
    trans_w = case == "trans_w"
    x, w, named = _inputs(3, "int8", opt, trans_w=trans_w)
    got, want = _run_both(x, jnp.asarray(w), torch.from_numpy(w), named,
                          "int8", backend, trans_w=trans_w,
                          activation=opt.get("activation"))
    np.testing.assert_allclose(got, want, **TOL["int8"])


def test_quantize_per_tensor_matches_reference_bits():
    from repro.core.policy import quantize_per_tensor as jq
    from repro_torch.core.policy import quantize_per_tensor as tq

    rng = np.random.default_rng(0)
    for x in (_draw(rng, (64, 96)), np.zeros((3, 4), np.float32),
              np.array([[0.5, -127.0, 1e-12]], np.float32)):
        qj, sj = jq(jnp.asarray(x))
        qt, st = tq(torch.from_numpy(x))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.float32(sj).tobytes()


def test_packed_trans_w_must_match_the_layout():
    w = tpack.pack_operand(torch.ones(16, 8), (8, 8), trans_w=True,
                           dtype="int4")
    x = torch.ones(2, 8)
    assert tuple(mp_dot(x, w, trans_w=True).shape) == (2, 16)
    with pytest.raises(ValueError, match="trans_w"):
        mp_dot(x, w)


def test_float_payload_under_int8_unpacks_on_the_cpu_and_raises_off_it():
    """The reference's unpack fallback (a float payload under the int8
    policy): the plain unpack on the CPU, K7 on the card, and a raise on
    any other device, never a fallback."""
    x = torch.randn(3, 16)
    w = torch.randn(16, 8)
    p = tpack.pack_operand(w, (8, 8), dtype="float32")
    dense = mp_dot(x, w, policy="int8")
    torch.testing.assert_close(mp_dot(x, p, policy="int8"), dense,
                               atol=0, rtol=0)
    k7 = tpack.unpack_operand.launches
    with pytest.raises(ValueError, match="device"):
        mp_dot(x.to("meta"), p.to("meta"), policy="int8")
    assert tpack.unpack_operand.launches == k7
    k1 = mpgemm.launches
    with pytest.raises(ValueError, match="device"):
        mp_dot(x.to("meta"), w.to("meta"), policy="int8")
    assert mpgemm.launches == k1
