"""Parity of the port's op-level GEMM API (``repro_torch.kernels.ops``,
``repro_torch.kernels.ref``) with the JAX package's.

The port runs on CPU tensors, so its K1, K2 and K3 wrappers take their
plain versions; the reference runs ``ops.mpgemm(..., interpret=True)`` (the
Pallas bodies in interpret mode) and ``kernels.ref.mpgemm_ref``.  Inputs are
drawn with numpy from a seed and handed to both packages.

Tolerances: int8 operands give int32 outputs that must be EQUAL (both sum
exactly and keep the integer epilogue).  f32 outputs: atol = rtol = 1e-4
(the two packages sum the K products in another order; K <= 256 here).
bf16 outputs: atol = rtol = 1.6e-2, one bf16 ulp (2**-8 relative) at |y|
up to 4, since another summation order can put the f32 result on the other
side of a bf16 rounding.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mpgemm import mpgemm_grouped_pallas  # noqa: E402
from repro.packing import pack_operand as jax_pack  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.packing.pack import pack_operand  # noqa: E402

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1.6e-2, rtol=1.6e-2)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _f32(rng, shape, bf16=False):
    a = rng.standard_normal(shape).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _both(a, t_dtype=None):
    """(jax array, torch tensor) of one numpy array; bf16 via ml_dtypes."""
    if t_dtype == torch.bfloat16:
        return jnp.asarray(a.astype(ml_dtypes.bfloat16)), \
            torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(t):
    return t.float().numpy().astype(np.float64)


# --- float epilogues: the six cases of tests/test_mpgemm_kernel.py ----------

@pytest.mark.parametrize("kw", [
    dict(alpha=0.5),
    dict(alpha=1.5, beta=2.0),
    dict(bias=True),
    dict(bias=True, activation="silu"),
    dict(activation="gelu", alpha=0.7, beta=0.3),
    dict(activation="relu"),
], ids=["alpha", "alpha_beta_c", "bias", "bias_silu", "gelu_alpha_beta",
        "relu"])
def test_mpgemm_epilogue_matches_reference(kw):
    rng = np.random.default_rng(0)
    m, n, k = 96, 144, 160
    kw = dict(kw)
    aj, at = _both(_f32(rng, (m, k)))
    bj, bt = _both(_f32(rng, (k, n)))
    cj = ct = None
    if kw.get("beta"):
        cj, ct = _both(_f32(rng, (m, n)))
    if kw.pop("bias", False):
        bias_j, bias_t = _both(_f32(rng, (n,)))
        kw_j, kw_t = dict(kw, bias=bias_j), dict(kw, bias=bias_t)
    else:
        kw_j = kw_t = kw
    want = jops.mpgemm(aj, bj, cj, interpret=True, **kw_j)
    got = ops.mpgemm(at, bt, ct, **kw_t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


@pytest.mark.parametrize("trans_a,trans_b", [(True, False), (False, True),
                                             (True, True)])
@pytest.mark.parametrize("m,n,k", [(128, 128, 256), (100, 70, 50)])
def test_mpgemm_transposes_match_reference(trans_a, trans_b, m, n, k):
    rng = np.random.default_rng(1)
    aj, at = _both(_f32(rng, (k, m) if trans_a else (m, k)))
    bj, bt = _both(_f32(rng, (n, k) if trans_b else (k, n)))
    want = jops.mpgemm(aj, bj, trans_a=trans_a, trans_b=trans_b,
                       interpret=True)
    got = ops.mpgemm(at, bt, trans_a=trans_a, trans_b=trans_b)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


def test_mpgemm_bf16_with_every_epilogue_operand():
    rng = np.random.default_rng(2)
    aj, at = _both(_f32(rng, (40, 96), True), torch.bfloat16)
    bj, bt = _both(_f32(rng, (96, 72), True), torch.bfloat16)
    cj, ct = _both(_f32(rng, (40, 72), True), torch.bfloat16)
    bias_j, bias_t = _both(_f32(rng, (72,)))
    kw = dict(alpha=1.5, beta=2.0, activation="gelu")
    want = jops.mpgemm(aj, bj, cj, bias=bias_j, interpret=True, **kw)
    got = ops.mpgemm(at, bt, ct, bias=bias_t, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               **BF16)


# --- int8 -> int32 -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),
    dict(alpha=2.0, beta=3.0, bias=True),
    dict(activation="relu", bias=True),
    dict(trans_a=True),
    dict(trans_a=True, trans_b=True),
    dict(trans_b=True, beta=-1.0),
], ids=["plain", "alpha_beta_bias", "relu_bias", "trans_a",
        "trans_a_trans_b", "trans_b_beta"])
def test_mpgemm_int8_to_int32_is_bit_equal(kw):
    """The paper's INT8 -> INT32 GEMM: the default output is int32 and the
    epilogue stays in integers (alpha, beta and the bias truncated to
    int32), equal to the reference's interpret kernel."""
    rng = np.random.default_rng(3)
    m, n, k = 48, 80, 200
    kw = dict(kw)
    ta, tb = kw.get("trans_a", False), kw.get("trans_b", False)
    aj, at = _both(_i8(rng, (k, m) if ta else (m, k)))
    bj, bt = _both(_i8(rng, (n, k) if tb else (k, n)))
    cj = ct = None
    if kw.get("beta"):
        cj, ct = _both(rng.integers(-1000, 1000, (m, n)).astype(np.int32))
    if kw.pop("bias", False):
        bias_j, bias_t = _both((rng.standard_normal(n) * 50).astype(
            np.float32))
        kw_j, kw_t = dict(kw, bias=bias_j), dict(kw, bias=bias_t)
    else:
        kw_j = kw_t = kw
    want = np.asarray(jops.mpgemm(aj, bj, cj, interpret=True, **kw_j))
    got = ops.mpgemm(at, bt, ct, **kw_t)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int32_alpha_truncation_follows_the_reference():
    """A reference fault kept as it is: with an int32 accumulator,
    ``apply_epilogue`` casts alpha to int32, so ``alpha=0.5`` gives zeros
    and ``beta=0.5`` drops C (int8 (8, 64) x (64, 16), numpy seed 0).  The
    port truncates the same way."""
    rng = np.random.default_rng(0)
    aj, at = _both(rng.integers(-127, 128, (8, 64)).astype(np.int8))
    bj, bt = _both(rng.integers(-127, 128, (64, 16)).astype(np.int8))
    want = np.asarray(jops.mpgemm(aj, bj, alpha=0.5, interpret=True))
    got = ops.mpgemm(at, bt, alpha=0.5)
    assert not want.any() and not got.any()
    cj, ct = _both(np.full((8, 16), 5, np.int32))
    plain = ops.mpgemm(at, bt)
    want = np.asarray(jops.mpgemm(aj, bj, cj, beta=0.5, interpret=True))
    got = ops.mpgemm(at, bt, ct, beta=0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, plain)


def test_int32_float_output_keeps_the_integer_epilogue():
    """An f32 output of an int8 product with no scale: the epilogue still
    runs in int32 before the cast (alpha 0.5 -> 0), as the reference's."""
    rng = np.random.default_rng(4)
    aj, at = _both(_i8(rng, (16, 64)))
    bj, bt = _both(_i8(rng, (64, 24)))
    for alpha in (0.5, 2.5):
        want = jops.mpgemm(aj, bj, alpha=alpha, out_dtype=jnp.float32,
                           interpret=True)
        got = ops.mpgemm(at, bt, alpha=alpha, out_dtype=torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_with_a_scale_runs_the_f32_epilogue():
    rng = np.random.default_rng(5)
    aj, at = _both(_i8(rng, (16, 64)))
    bj, bt = _both(_i8(rng, (64, 24)))
    want = jops.mpgemm(aj, bj, scale=0.013, alpha=0.5, activation="silu",
                       out_dtype=jnp.float32, interpret=True)
    got = ops.mpgemm(at, bt, scale=0.013, alpha=0.5, activation="silu",
                     out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(beta=2.0)],
                         ids=["gelu", "gelu_beta_c"])
def test_integer_accumulator_activations(kw):
    """silu on an int32 accumulator raises TypeError in both packages; the
    tanh GELU turns it into f32 and the int32 output truncates the result,
    equal to the reference's."""
    rng = np.random.default_rng(6)
    aj, at = _both(_i8(rng, (8, 64)))
    bj, bt = _both(_i8(rng, (64, 16)))
    with pytest.raises(TypeError):
        jops.mpgemm(aj, bj, activation="silu", interpret=True)
    with pytest.raises(TypeError, match="integer accumulator"):
        ops.mpgemm(at, bt, activation="silu")
    cj = ct = None
    if kw:
        cj, ct = _both(_f32(rng, (8, 16)) * 100)
    want = np.asarray(jops.mpgemm(aj, bj, cj, activation="gelu",
                                  interpret=True, **kw))
    got = ops.mpgemm(at, bt, ct, activation="gelu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)


# --- grouped beta·C, packed and sparse beta·C -------------------------------

def test_grouped_beta_c_matches_reference():
    """beta·C on the grouped path (``tests/test_gemm_spec.py``'s case)."""
    rng = np.random.default_rng(7)
    g, m, k, n = 3, 24, 40, 32
    aj, at = _both(_f32(rng, (g, m, k)))
    bj, bt = _both(_f32(rng, (g, k, n)))
    cj, ct = _both(_f32(rng, (g, m, n)))
    want = mpgemm_grouped_pallas(aj, bj, cj, beta=0.5, alpha=2.0,
                                 activation="relu", interpret=True)
    got = tk.mpgemm_grouped(at, bt, c=ct, epilogue=EpilogueSpec(
        alpha=2.0, beta=0.5, activation="relu"))
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


@pytest.mark.parametrize("payload", ["float32", "int8", "int4", "fp8e4m3"])
def test_packed_beta_c_matches_reference(payload):
    """K2 with beta·C through ``ops.mpgemm(a, packed, c, beta=...)``; f32 A
    against a float32 or codec payload (tile dequant in the reference's
    order)."""
    rng = np.random.default_rng(8)
    m, k, n = 20, 72, 48
    aj, at = _both(_f32(rng, (m, k)))
    w = _f32(rng, (k, n))
    cj, ct = _both(_f32(rng, (m, n)))
    pj = jax_pack(jnp.asarray(w), (32, 16), dtype=payload, backend="xla")
    pt = pack_operand(torch.from_numpy(w), (32, 16), dtype=payload)
    kw = dict(alpha=1.5, beta=2.0, activation="relu")
    want = jops.mpgemm(aj, pj, cj, interpret=True, **kw)
    got = ops.mpgemm(at, pt, ct, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


@pytest.mark.parametrize("payload", ["float32", "int8"])
def test_sparse_beta_c_matches_reference(payload):
    """K3 with beta·C, an empty column included; f32 A against f32 tiles,
    and against int8 tiles (the float x int8 variant)."""
    rng = np.random.default_rng(9)
    m, k, n, blocks = 20, 96, 64, (32, 16)
    aj, at = _both(_f32(rng, (m, k)))
    w = _f32(rng, (k, n))
    cj, ct = _both(_f32(rng, (m, n)))
    keep = rng.random((3, 4)) < 0.5
    keep[:, 1] = False
    keep[0, 0] = True
    sj = js.sparsify_with_mask(jnp.asarray(w), blocks, keep, dtype=payload)
    st = ts.sparsify_with_mask(torch.from_numpy(w), blocks, keep,
                               dtype=payload)
    kw = dict(alpha=0.5, beta=3.0, bias=None)
    want = jops.mpgemm(aj, sj, cj, interpret=True, **kw)
    got = ops.mpgemm(at, st, ct, **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


def test_trans_a_against_a_packed_operand_is_refused():
    """``trans_a`` against a packed B, once refused, is ported now (K2 on
    the copied Aᵀ on the card): it matches the reference (more cases in
    ``tests/test_torch_k1_design.py``)."""
    rng = np.random.default_rng(12)
    w = _f32(rng, (32, 16))
    aj, at = _both(_f32(rng, (32, 4)))
    want = jops.mpgemm(aj, jax_pack(jnp.asarray(w), (16, 16),
                                    dtype="float32"),
                       trans_a=True, interpret=True)
    got = ops.mpgemm(at, pack_operand(torch.from_numpy(w), (16, 16),
                                      dtype="float32"), trans_a=True)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64), **F32)


# --- the oracle -------------------------------------------------------------

@pytest.mark.parametrize("case", ["int8", "f32_gate", "bf16_residual",
                                  "grouped_bias"])
def test_mpgemm_ref_matches_reference_oracle(case):
    rng = np.random.default_rng(10)
    kw_j, kw_t = {}, {}
    if case == "int8":
        aj, at = _both(_i8(rng, (8, 40)))
        bj, bt = _both(_i8(rng, (40, 12)))
        kw_j = kw_t = dict(alpha=3.0)
    elif case == "grouped_bias":
        aj, at = _both(_f32(rng, (2, 8, 40)))
        bj, bt = _both(_f32(rng, (2, 40, 12)))
        bias_j, bias_t = _both(_f32(rng, (12,)))
        kw_j, kw_t = dict(bias=bias_j), dict(bias=bias_t)
    else:
        bf = case.startswith("bf16")
        dt = torch.bfloat16 if bf else None
        aj, at = _both(_f32(rng, (8, 40), bf), dt)
        bj, bt = _both(_f32(rng, (40, 12), bf), dt)
        name = "residual" if bf else "gate"
        ej, et = _both(_f32(rng, (8, 12), bf), dt)
        kw_j, kw_t = {name: ej, "activation": "silu"}, \
            {name: et, "activation": "silu"}
    want = np.asarray(jref.mpgemm_ref(aj, bj, **kw_j), np.float64)
    got = tref.mpgemm_ref(at, bt, **kw_t)
    if case == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(_np(got), want,
                                   **(BF16 if case.startswith("bf16")
                                      else F32))


# --- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_flash_attention_matches_reference(causal, window):
    rng = np.random.default_rng(11)
    qj, qt = _both(_f32(rng, (1, 4, 12, 16)))
    kj, kt = _both(_f32(rng, (1, 2, 12, 16)))
    vj, vt = _both(_f32(rng, (1, 2, 12, 16)))
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                interpret=True, block_q=8, block_k=8)
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               atol=1e-5, rtol=1e-5)


def test_flash_attention_fallback_reason_and_plain_formula():
    """Non-float operands: the reason names the operand; on the CPU the
    plain formula runs and equals the reference's XLA fallback (int32
    inputs, the scores in int32 and the output truncated to int32 in
    both)."""
    assert ops.flash_attention_fallback_reason(
        torch.float32, torch.bfloat16, torch.float32) is None
    reason = ops.flash_attention_fallback_reason(
        torch.float32, torch.int32, torch.float32)
    assert "non-float k" in reason
    rng = np.random.default_rng(12)
    qj, qt = _both(rng.integers(-3, 4, (1, 2, 6, 8)).astype(np.int32))
    kj, kt = _both(rng.integers(-3, 4, (1, 1, 6, 8)).astype(np.int32))
    vj, vt = _both(rng.integers(-50, 50, (1, 1, 6, 8)).astype(np.int32))
    want = jops.flash_attention(qj, kj, vj, interpret=True)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_attention_ref_matches_reference_oracle():
    rng = np.random.default_rng(13)
    qj, qt = _both(_f32(rng, (2, 3, 5, 8), True), torch.bfloat16)
    kj, kt = _both(_f32(rng, (2, 3, 7, 8), True), torch.bfloat16)
    want = jref.flash_attention_ref(qj, kj, kj, causal=True, window=4)
    got = tref.flash_attention_ref(qt, kt, kt, causal=True, window=4)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               **BF16)


# --- chip_smoke's copy of Table III -----------------------------------------

def test_chip_smoke_copies_the_paper_workloads():
    """``chip_smoke.py`` keeps its own copy of Table III (the port imports
    nothing of the JAX package); it must equal
    ``benchmarks/common.py::PAPER_WORKLOADS``."""
    import sys
    sys.path.insert(0, REPO)
    from benchmarks.common import PAPER_WORKLOADS
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.TABLE_III == PAPER_WORKLOADS
