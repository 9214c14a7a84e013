"""Parity of the port's grouped ``mp_dot_grouped`` with the JAX package's.

The port runs on CPU tensors, so its grouped wrappers take the plain
versions (K1's for a dense (G, K, N) stack, K2's for a grouped packed
operand).  The JAX side runs under ``gemm_backend("interpret")``, which
reaches the Pallas grouped body (``make_gemm_kernel.kernel`` with the group
as the leading grid axis, via ``mpgemm_grouped_pallas``) in interpret mode,
and, for dense stacks, also under the ``xla`` backend.  Inputs are drawn
with numpy from a seed and rounded to bf16 through ``ml_dtypes`` where the
policy computes in bf16, so both packages see the same bits.  Packed stacks
are packed by each package from the same f32 stack with the same blocks
(byte-identical payloads: ``test_torch_packing.py``).

Tolerances, by output dtype: f32 outputs atol = rtol = 1e-5 (the two sum
the K products in another order; int8 sums are exact in both); bf16
outputs atol = rtol = 1.6e-2, one bf16 ulp (2**-8) at |y| up to 4, since a
different summation order can put the f32 result on the other side of a
bf16 rounding boundary.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro.packing import pack as jpack  # noqa: E402
from repro_torch.core.gemm import mp_dot, mp_dot_grouped  # noqa: E402
from repro_torch.kernels.mpgemm import (  # noqa: E402
    mpgemm, mpgemm_grouped, mpgemm_packed, mpgemm_packed_grouped,
)
from repro_torch.packing import pack as tpack  # noqa: E402

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1.6e-2, rtol=1.6e-2)}
OUT = {"float32": (torch.float32, np.float32),
       "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}
POLICY_OUT = {"fp32": "float32", "bf16": "bfloat16", "int8": "bfloat16"}

# (G, M, K, N, options).  K = 300 and N = 100 are off every tile of the
# reference's planner; M = 7 and 9 are off the row tile.  ``bias`` is "gn"
# for a (G, N) bias and "n" for a shared (N,) one; ``out`` overrides the
# policy's output dtype (the MoE expert GEMMs run with f32 outputs).
CASES = {
    "g1_linear": (1, 5, 96, 136, {}),
    "g3_ragged_bias_gn_relu": (3, 7, 300, 100,
                               dict(bias="gn", activation="relu")),
    "g8_gated_silu_f32_out": (8, 4, 96, 72,
                              dict(gate=True, activation="silu",
                                   out="float32")),
    "g3_residual_bias_n": (3, 9, 130, 64, dict(residual=True, bias="n")),
    "g3_trans_w": (3, 6, 96, 80, dict(trans_w=True)),
    "g8_group_sizes_f32_out": (8, 6, 64, 48,
                               dict(group_sizes=True, out="float32")),
}


def _draw(rng, shape, bf16, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _inputs(case, policy, seed):
    g, m, k, n, opt = CASES[case]
    rng = np.random.default_rng(seed)
    bf16 = policy != "fp32"
    x = _draw(rng, (g, m, k), bf16)
    w = _draw(rng, (g, n, k) if opt.get("trans_w") else (g, k, n), False,
              scale=(2.0 / (k + n)) ** 0.5)
    named = {nm: _draw(rng, (g, m, n), bf16)
             for nm in ("gate", "residual") if opt.get(nm)}
    bias = None
    if opt.get("bias"):
        bias = rng.standard_normal((g, n) if opt["bias"] == "gn"
                                   else (n,)).astype(np.float32)
    sizes = (rng.integers(0, m + 1, g).astype(np.int32)
             if opt.get("group_sizes") else None)
    return x, w, named, bias, sizes


def _run_both(case, policy, backend, w_j, w_t, x, named, bias, sizes):
    opt = CASES[case][4]
    out_name = opt.get("out", POLICY_OUT[policy])
    out_t, out_np = OUT[out_name]
    kw = dict(policy=policy, trans_w=opt.get("trans_w", False),
              activation=opt.get("activation"))
    with jcfg.gemm_backend(backend):
        want = jax_mp_dot_grouped(
            jnp.asarray(x), w_j,
            None if bias is None else jnp.asarray(bias),
            group_sizes=None if sizes is None else jnp.asarray(sizes),
            out_dtype=jnp.dtype(out_name) if "out" in opt else None,
            **{nm: jnp.asarray(v.astype(out_np)) for nm, v in named.items()},
            **kw)
    got = mp_dot_grouped(
        torch.from_numpy(x), w_t,
        None if bias is None else torch.from_numpy(bias),
        group_sizes=None if sizes is None else torch.from_numpy(sizes),
        out_dtype=out_t if "out" in opt else None,
        **{nm: torch.from_numpy(v).to(out_t) for nm, v in named.items()},
        **kw)
    assert got.dtype == out_t and tuple(got.shape) == tuple(want.shape)
    return got.float().numpy(), np.asarray(want).astype(np.float32), out_t


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_mp_dot_matches_reference(case, policy, backend):
    x, w, named, bias, sizes = _inputs(case, policy,
                                       sorted(CASES).index(case))
    k1 = (mpgemm.launches, mpgemm_grouped.launches)
    got, want, out_t = _run_both(case, policy, backend, jnp.asarray(w),
                                 torch.from_numpy(w), x, named, bias, sizes)
    np.testing.assert_allclose(got, want, **TOL[out_t])
    if sizes is not None:
        rows = np.arange(got.shape[1])[None, :, None]
        assert (got[np.broadcast_to(rows >= sizes[:, None, None],
                                    got.shape)] == 0).all()
    assert (mpgemm.launches, mpgemm_grouped.launches) == k1   # plain: CPU


# (policy, payload): what mp_dot_grouped hands grouped K2 under each policy.
PACKED = [("bf16", "bfloat16"), ("bf16", "int8"), ("bf16", "int4"),
          ("bf16", "fp8e4m3"), ("int8", "int8"), ("int8", "int4")]
PACKED_CASES = ["g3_ragged_bias_gn_relu", "g3_trans_w",
                "g8_gated_silu_f32_out", "g8_group_sizes_f32_out"]
# Blocks with a K tail (300 = 2 * 128 + 44), ragged column tiles and an odd
# bk for int4's dangling nibble.
BLOCKS = {"g3_ragged_bias_gn_relu": (128, 64), "g3_trans_w": (33, 32),
          "g8_gated_silu_f32_out": (32, 64),
          "g8_group_sizes_f32_out": (64, 16)}


@pytest.mark.parametrize("policy,payload", PACKED)
@pytest.mark.parametrize("case", PACKED_CASES)
def test_grouped_packed_mp_dot_matches_interpret_kernel(case, policy,
                                                        payload):
    x, w, named, bias, sizes = _inputs(case, policy,
                                       10 + PACKED_CASES.index(case))
    trans_w = CASES[case][4].get("trans_w", False)
    w_j = jpack.pack_operand(jnp.asarray(w), BLOCKS[case], trans_w=trans_w,
                             dtype=payload, backend="xla")
    w_t = tpack.pack_operand(torch.from_numpy(w), BLOCKS[case],
                             trans_w=trans_w, dtype=payload)
    assert w_t.layout.g == w_j.layout.g == CASES[case][0]
    k2 = (mpgemm_packed.launches, mpgemm_packed_grouped.launches)
    got, want, out_t = _run_both(case, policy, "interpret", w_j, w_t, x,
                                 named, bias, sizes)
    np.testing.assert_allclose(got, want, **TOL[out_t])
    assert (mpgemm_packed.launches, mpgemm_packed_grouped.launches) == k2


def test_grouped_operands_are_checked():
    x = torch.ones(3, 2, 8)
    with pytest.raises(ValueError, match="rank 3"):
        mp_dot_grouped(x[0], torch.ones(3, 8, 4))
    with pytest.raises(ValueError, match=r"\(3, \., \.\)"):
        mp_dot_grouped(x, torch.ones(2, 8, 4))
    packed = tpack.pack_operand(torch.ones(3, 8, 4), (8, 4), dtype="int4")
    with pytest.raises(ValueError, match="group mismatch"):
        mp_dot_grouped(torch.ones(2, 2, 8), packed)
    with pytest.raises(ValueError, match="trans_w"):
        mp_dot_grouped(x, packed, trans_w=True)
    with pytest.raises(ValueError, match="mp_dot_grouped"):
        mp_dot(x[0], packed)
    assert tuple(mp_dot_grouped(x, packed).shape) == (3, 2, 4)


def test_grouped_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """Meta tensors never reach a plain version; the CPU path launches
    nothing."""
    before = (mpgemm_grouped.launches, mpgemm_packed_grouped.launches)
    a, b = torch.ones(3, 2, 8), torch.ones(3, 8, 4)
    packed = tpack.pack_operand(b, (8, 4), dtype="int8")
    assert mpgemm_grouped(a, b).shape == (3, 2, 4)
    assert mpgemm_grouped(a, packed).shape == (3, 2, 4)
    for bb in (b.to("meta"), packed.to("meta")):
        with pytest.raises(ValueError, match="device"):
            mpgemm_grouped(a.to("meta"), bb)
    assert (mpgemm_grouped.launches,
            mpgemm_packed_grouped.launches) == before
