"""The port's K4 (``repro_torch.kernels.flash_attention.flash_attention``)
and the attention cores of ``repro_torch.models.attention`` against the JAX
package's, on the CPU.

K4's plain version (the CPU path of the wrapper) is held against the
reference Pallas kernel run in interpret mode (``flash_attention(...,
interpret=True)``), whose blocks are ``bq = min(256, max(8, tq))`` and
``bk = min(512, max(128, tk))``: tk = 700 leaves a KV tail in its second
block, tk = 1100 spans three blocks.  ``decode_attention`` is held against
the reference's.  Inputs are drawn with numpy (seeded) and handed to both.

Tolerances: f32 atol = rtol = 1e-5 (summation order only).  bf16 (inputs
rounded to bf16 once, for both): both compute in f32 and round the output
to bf16 once, so they may differ by one bf16 rounding of the result, rtol
= 2**-7 (a bf16 ulp is at most 2**-7 of the value) with atol = 1e-6.
``decode_attention`` rounds P to the cache dtype in both packages: the
same tolerances.

A query row that sees no key (tq > tk under causal; no caller makes one)
is finite in both, but the reference averages the V rows of its TPU
blocks, a value that depends on its block size: such rows are only
checked for finiteness.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain,
)
from repro_torch.models import attention as tattn  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-6, rtol=2 ** -7)}


def _inputs(seed, dtype, *shapes):
    """Seeded numpy arrays rounded to ``dtype`` once, as (jax, torch)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16)
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out.append((jnp.asarray(a), t))
    return out


def _np(t):
    return t.float().numpy()


# b, h, hkv, tq, tk, d, causal, window
CASES = [
    (2, 4, 4, 16, 16, 64, True, None),        # causal prefill, MHA
    (2, 4, 4, 16, 16, 64, False, None),       # non-causal (encoder)
    (1, 4, 2, 9, 40, 96, True, None),         # tq < tk, right-aligned, GQA 2
    (2, 8, 2, 12, 12, 64, True, 5),           # window, GQA 4
    (1, 4, 1, 6, 30, 96, True, 7),            # window with tq < tk, GQA 4
    (1, 2, 2, 1, 700, 64, False, None),       # decode cross-attn, KV tail
    (1, 4, 2, 20, 1100, 64, False, None),     # three reference KV blocks
    (1, 2, 1, 9, 1100, 96, True, None),       # causal over three blocks
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal,window", CASES)
def test_flash_attention_plain_matches_interpret_kernel(
        dtype, b, h, hkv, tq, tk, d, causal, window):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        tq + tk, dtype, (b, h, tq, d), (b, hkv, tk, d), (b, hkv, tk, d))
    want = jfa.flash_attention(qj, kj, vj, causal=causal, window=window,
                               interpret=True)
    launches = flash_attention.launches
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert flash_attention.launches == launches     # the plain path
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_fully_masked_rows_are_finite_and_the_rest_agree():
    """tq = 8 > tk = 4 under causal: rows 0..3 see no key."""
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        3, "float32", (1, 2, 8, 64), (1, 2, 4, 64), (1, 2, 4, 64))
    want = np.asarray(jfa.flash_attention(qj, kj, vj, causal=True,
                                          interpret=True))
    got = _np(flash_attention(qt, kt, vt, causal=True))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got[:, :, 4:], want[:, :, 4:],
                               **TOL["float32"])


def test_attention_core_dispatches_cpu_tensors_to_the_plain_version():
    """No backend argument: a CPU tensor runs the plain version, strided
    inputs (heads split off a projection) included."""
    (_, qt), (_, kt), (_, vt) = _inputs(
        5, "float32", (2, 6, 4, 32), (2, 6, 2, 32), (2, 6, 2, 32))
    q, k, v = (t.transpose(1, 2) for t in (qt, kt, vt))   # (B, H, T, D)
    assert not q.is_contiguous()
    launches = flash_attention.launches
    got = tattn.attention_core(q, k, v, causal=True, window=3)
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True, window=3)
    assert torch.equal(got, want)
    assert flash_attention.launches == launches
    with pytest.raises(ValueError, match="device"):
        tattn.attention_core(q.to("meta"), k.to("meta"), v.to("meta"))


def test_attention_core_matches_reference_xla_cores():
    """The reference's CPU dispatch picks dense, banded or chunked XLA
    attention by shape; the math is K4's (f32 inputs, so the reference's
    rounding of P to V's dtype is exact)."""
    for tq, tk, causal, window in ((10, 10, True, None), (30, 30, True, 4),
                                   (3, 2100, False, None)):
        (qj, qt), (kj, kt), (vj, vt) = _inputs(
            tq, "float32", (1, 4, tq, 32), (1, 2, tk, 32), (1, 2, tk, 32))
        want = jattn.attention_core(qj, kj, vj, causal=causal,
                                    window=window, backend="xla")
        got = tattn.attention_core(qt, kt, vt, causal=causal, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,hkv,s,length", [(4, 4, 16, 9), (8, 2, 24, 24),
                                            (4, 1, 10, 1)])
def test_decode_attention_matches_reference(dtype, h, hkv, s, length):
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        s, dtype, (3, h, 1, 64), (3, hkv, s, 64), (3, hkv, s, 64))
    lengths = np.full((3,), length, np.int32)
    want = jattn.decode_attention(qj, kj, vj, jnp.asarray(lengths))
    got = tattn.decode_attention(qt, kt, vt, length)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_flash_attention_refuses_bad_shapes():
    q = torch.zeros(1, 3, 4, 8)
    kv = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, kv, kv)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="key"):
        flash_attention(q, kv[:, :, :0], kv[:, :, :0])
