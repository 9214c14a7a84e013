"""Parity of the port's ``mp_einsum`` with the JAX package's.

A grouped-matmul spec goes through ``mp_dot_grouped`` in both packages
(the reference on ``gemm_backend("interpret")``, its Pallas grouped K1 in
interpret mode; the port the grouped K1 wrapper, whose plain version runs
for CPU tensors); any other spec is a plain einsum under the policy's
dtypes.  Inputs are drawn with numpy from a seed.

Tolerances: fp32 outputs atol = rtol = 1e-5 (another summation order);
bf16 outputs atol = rtol = 1.6e-2 (one bf16 ulp, 2**-8 relative, at |y|
up to 4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import _as_grouped_matmul as jax_as_grouped  # noqa: E402
from repro.core.gemm import mp_einsum as jax_mp_einsum  # noqa: E402
from repro_torch.core import gemm as tgemm  # noqa: E402
from repro_torch.core.gemm import _as_grouped_matmul, mp_einsum  # noqa: E402

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2),
       "int8": dict(atol=1.6e-2, rtol=1.6e-2)}

SPECS = {
    "grouped": ("gmk,gkn->gmn", [(3, 5, 24), (3, 24, 16)]),
    "grouped_trans": ("gmk,gnk->gmn", [(3, 5, 24), (3, 16, 24)]),
    "grouped_letters": ("eab,ebc->eac", [(2, 7, 33), (2, 33, 9)]),
    "scores": ("bhqd,bhkd->bhqk", [(2, 3, 5, 8), (2, 3, 6, 8)]),
    "values": ("bhqk,bhkd->bhqd", [(2, 3, 5, 6), (2, 3, 6, 8)]),
    "outer": ("i,j->ij", [(7,), (5,)]),
}


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(SPECS))
def test_mp_einsum_matches_reference(case, policy, monkeypatch):
    spec, shapes = SPECS[case]
    rng = np.random.default_rng(sorted(SPECS).index(case))
    ops = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    with jcfg.gemm_backend("interpret"):
        want = jax_mp_einsum(spec, *map(jnp.asarray, ops), policy=policy)
    grouped = []
    real = tgemm.mp_dot_grouped

    def spy(*a, **kw):
        grouped.append(kw.get("trans_w"))
        return real(*a, **kw)

    monkeypatch.setattr(tgemm, "mp_dot_grouped", spy)
    got = mp_einsum(spec, *map(torch.from_numpy, ops), policy=policy)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert bool(grouped) == case.startswith("grouped")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[policy])


@pytest.mark.parametrize("spec", [
    "gmk,gkn->gmn", "gmk,gnk->gmn", "xab,xbc->xac", "gmk,gkn->gnm",
    "gmk,gkm->gmm", "mk,kn->mn", "gmk,hkn->gmn", "gmk,gkn", "a,b,c->abc",
    "gmk,gkn->gmnk"])
def test_grouped_matmul_detection_matches_reference(spec):
    n_ops = len(spec.split("->")[0].split(","))
    assert _as_grouped_matmul(spec, n_ops) == jax_as_grouped(spec, n_ops)


def test_integer_operands_stay_off_the_grouped_path(monkeypatch):
    """Only float operands take the grouped GEMM; an int operand keeps the
    plain einsum, as in the reference."""
    calls = []
    monkeypatch.setattr(tgemm, "mp_dot_grouped",
                        lambda *a, **kw: calls.append(1))
    a = torch.ones(2, 3, 4)
    b = torch.ones(2, 4, 5, dtype=torch.int32)
    out = mp_einsum("gmk,gkn->gmn", a, b, policy="fp32")
    assert not calls and out.shape == (2, 3, 5)
