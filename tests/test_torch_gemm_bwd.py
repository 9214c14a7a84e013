"""Parity of the port's ``mp_dot`` / ``mp_dot_grouped`` gradients with
``jax.grad`` of the JAX package's, and of K1's ``trans_a`` plain version
with the reference kernel.

The port runs on CPU tensors, so its autograd function's backward GEMMs
take K1's plain version (``trans_b`` for dx, ``trans_a`` for dW) and K7's
(the unpacker).  The JAX side runs under ``gemm_backend("interpret")``:
its custom VJP (``_gemm_bwd``) runs the Pallas K1 body in interpret mode
with f32 sums, the kernel path's numerics (its ``xla`` backend sums the
backward in bf16 instead).  Inputs are drawn with numpy from a seed; bf16
operands go through ``ml_dtypes``, so both packages see the same bits.
Weights are f32 masters, as in training; the cotangent of the output is a
drawn ``dy``.

Tolerances: every gradient under fp32 atol = rtol = 1e-4 (f32 sums of up
to 300 products in another order).  Under bf16 and int8 (the backward in
bf16, the straight-through estimator) atol = rtol = 1.6e-2, one bf16 ulp
(2**-8) at magnitudes up to 4: dx is a bf16 output, and dW, though an f32
output, sums bf16 operands -- the f32 cotangent through the epilogue is
rounded to bf16 before the GEMMs, and a recomputed pre-tail value that
differs in the last f32 bit between the two sums can round one of them to
the neighbouring bf16 value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import gemm_spec as jspec  # noqa: E402
from repro.core.gemm import mp_dot as jax_mp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jax_mp_dot_grouped  # noqa: E402
from repro.kernels.mpgemm import mpgemm_grouped_pallas, mpgemm_pallas  # noqa: E402,E501
from repro.packing import pack as jpack  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.core import gemm_spec as tspec  # noqa: E402
from repro_torch.core.gemm import mp_dot, mp_dot_grouped  # noqa: E402
from repro_torch.kernels import mpgemm as tk  # noqa: E402
from repro_torch.packing import pack as tpack  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2),
       "int8": dict(atol=1.6e-2, rtol=1.6e-2)}
X_DT = {"fp32": (np.float32, torch.float32),
        "bf16": (ml_dtypes.bfloat16, torch.bfloat16),
        "int8": (ml_dtypes.bfloat16, torch.bfloat16)}


def _draw(rng, shape, scale=1.0, bf16=False):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if bf16:
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return a


def _pair(a, np_dt, t_dt):
    """The same values as a jax array and a torch tensor (grad-tracked)."""
    j = jnp.asarray(a.astype(np_dt))
    t = torch.from_numpy(a).to(t_dt).requires_grad_(True)
    return j, t


def _jax_grads(fn, primals, dy):
    def loss(*p):
        return jnp.sum(fn(*p).astype(jnp.float32) * dy)
    with jcfg.gemm_backend("interpret"):
        return jax.grad(loss, argnums=tuple(range(len(primals))))(*primals)


def _torch_grads(fn, primals, dy):
    y = fn(*primals)
    (y.float() * torch.from_numpy(dy)).sum().backward()
    return y, [p.grad for p in primals]


def _close(got, want, tol, label):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               err_msg=label, **tol)


def _kernel_launches():
    return (tk.mpgemm.launches, tk.mpgemm_grouped.launches,
            tpack.unpack_operand.launches, tpack.pack_operand.launches)


# (lead shape of x, K, N, options); K = 300 and N = 100 are off every tile.
CASES_2D = {
    "linear": ((2, 12), 96, 136, {}),
    "linear_gelu_bias": ((24,), 96, 136, dict(activation="gelu", bias=True)),
    "gated_silu": ((24,), 96, 136, dict(activation="silu", gate=True)),
    "residual": ((24,), 96, 136, dict(residual=True)),
    "residual_relu_bias": ((9,), 300, 100, dict(activation="relu",
                                                 residual=True, bias=True)),
    "alpha_relu": ((24,), 96, 136, dict(activation="relu", alpha=0.5)),
    "trans_w": ((24,), 96, 136, dict(trans_w=True)),
    "trans_w_gated_bias": ((7,), 300, 100, dict(trans_w=True, gate=True,
                                                 activation="silu",
                                                 bias=True)),
}


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES_2D))
def test_mp_dot_grads_match_jax_grad(case, policy):
    lead, k, n, opt = CASES_2D[case]
    rng = np.random.default_rng(sorted(CASES_2D).index(case))
    np_dt, t_dt = X_DT[policy]
    bf16 = policy != "fp32"
    trans_w = opt.get("trans_w", False)
    x = _draw(rng, (*lead, k), bf16=bf16)
    w = _draw(rng, (n, k) if trans_w else (k, n), (2.0 / (k + n)) ** 0.5)
    dy = rng.standard_normal((*lead, n)).astype(np.float32)
    names = ["x", "w"]
    arrays = [(x, np_dt, t_dt), (w, np.float32, torch.float32)]
    if opt.get("bias"):
        names.append("bias")
        arrays.append((rng.standard_normal(n).astype(np.float32),
                       np.float32, torch.float32))
    for nm in ("gate", "residual"):
        if opt.get(nm):
            names.append(nm)
            arrays.append((_draw(rng, (*lead, n), bf16=bf16), np_dt, t_dt))
    pj, pt = zip(*(_pair(*a) for a in arrays))
    alpha = opt.get("alpha", 1.0)

    def call(f, spec_mod, *p):
        kw = dict(zip(names[2:], p[2:]))
        if alpha != 1.0:
            kw["epilogue"] = spec_mod.EpilogueSpec(
                activation=opt.get("activation"), alpha=alpha)
        else:
            kw["activation"] = opt.get("activation")
        return f(p[0], p[1], kw.pop("bias", None), policy=policy,
                 trans_w=trans_w, **kw)

    want = _jax_grads(lambda *p: call(jax_mp_dot, jspec, *p), pj, dy)
    y, got = _torch_grads(lambda *p: call(mp_dot, tspec, *p), pt, dy)
    assert y.shape == (*lead, n)
    for nm, g, t, w_ in zip(names, got, pt, want):
        assert g.dtype == t.dtype and g.shape == t.shape, nm
        _close(g, w_, TOL[policy], f"d{nm}")


# (G, M, K, N, options): ragged group sizes, a (G, N) or shared (N,) bias.
CASES_GROUPED = {
    "ragged_linear": (3, 7, 96, 72, dict(sizes=(7, 3, 0))),
    "ragged_gated_f32_out": (4, 6, 64, 40, dict(sizes=(6, 2, 5, 1),
                                                gate=True, activation="silu",
                                                out="float32")),
    "bias_gn_residual": (2, 5, 300, 100, dict(bias=(2, 100), residual=True)),
    "bias_n_trans_w": (3, 4, 96, 40, dict(bias=(40,), trans_w=True,
                                          activation="relu")),
}


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES_GROUPED))
def test_mp_dot_grouped_grads_match_jax_grad(case, policy):
    g, m, k, n, opt = CASES_GROUPED[case]
    rng = np.random.default_rng(10 + sorted(CASES_GROUPED).index(case))
    np_dt, t_dt = X_DT[policy]
    bf16 = policy != "fp32"
    trans_w = opt.get("trans_w", False)
    out = opt.get("out")
    o_np, o_t = ((np.float32, torch.float32) if out == "float32"
                 else (np_dt, t_dt))
    x = _draw(rng, (g, m, k), bf16=bf16)
    w = _draw(rng, (g, n, k) if trans_w else (g, k, n),
              (2.0 / (k + n)) ** 0.5)
    dy = rng.standard_normal((g, m, n)).astype(np.float32)
    names = ["x", "w"]
    arrays = [(x, np_dt, t_dt), (w, np.float32, torch.float32)]
    if opt.get("bias"):
        names.append("bias")
        arrays.append((rng.standard_normal(opt["bias"]).astype(np.float32),
                       np.float32, torch.float32))
    for nm in ("gate", "residual"):
        if opt.get(nm):
            names.append(nm)
            arrays.append((_draw(rng, (g, m, n), bf16=bf16), o_np, o_t))
    pj, pt = zip(*(_pair(*a) for a in arrays))
    sizes = opt.get("sizes")

    def call(f, gs, out_dtype, *p):
        kw = dict(zip(names[2:], p[2:]))
        return f(p[0], p[1], kw.pop("bias", None), policy=policy,
                 trans_w=trans_w, group_sizes=gs, out_dtype=out_dtype,
                 activation=opt.get("activation"), **kw)

    want = _jax_grads(lambda *p: call(
        jax_mp_dot_grouped, None if sizes is None else jnp.asarray(sizes),
        None if out is None else jnp.float32, *p), pj, dy)
    _, got = _torch_grads(lambda *p: call(
        mp_dot_grouped, None if sizes is None else torch.tensor(sizes),
        None if out is None else torch.float32, *p), pt, dy)
    for nm, gr, t, w_ in zip(names, got, pt, want):
        assert gr.dtype == t.dtype and gr.shape == t.shape, nm
        _close(gr, w_, TOL[policy], f"d{nm}")
    if sizes is not None:
        # Rows past a group's size get no gradient.
        for gi, sz in enumerate(sizes):
            assert not got[0][gi, sz:].float().abs().sum()


BLOCKS = (32, 32)


@pytest.mark.parametrize("policy,payload", [
    ("bf16", "bfloat16"), ("fp32", "float32"), ("int8", "float32"),
    ("bf16", "int8"), ("bf16", "int4"), ("int8", "int4"),
    ("bf16", "fp8e4m3")])
@pytest.mark.parametrize("trans_w", [False, True])
def test_packed_weight_grads_match_jax_grad(policy, payload, trans_w):
    """Float payloads train: their cotangent is the packed dense gradient.
    Codec payloads are frozen: only dx flows.  A float payload under int8
    is unpacked (K7's plain version) in the forward too."""
    rng = np.random.default_rng(20)
    k, n = 96, 72
    np_dt, t_dt = X_DT[policy]
    x = _draw(rng, (5, k), bf16=policy != "fp32")
    w = _draw(rng, (n, k) if trans_w else (k, n), 0.1)
    dy = rng.standard_normal((5, n)).astype(np.float32)
    wj = jpack.pack_operand(jnp.asarray(w), BLOCKS, trans_w=trans_w,
                            dtype=payload, backend="xla")
    wt = tpack.pack_operand(torch.from_numpy(w), BLOCKS, trans_w=trans_w,
                            dtype=payload)
    trainable = wt.layout.codec is None
    xj, xt = _pair(x, np_dt, t_dt)

    def jfn(xx, ww=wj):
        return jax_mp_dot(xx, ww, policy=policy, trans_w=trans_w)

    def tfn(xx):
        return mp_dot(xx, wt, policy=policy, trans_w=trans_w)

    if trainable:
        wt.payload.requires_grad_(True)
        want_x, want_w = _jax_grads(jfn, (xj, wj), dy)
    else:
        (want_x,) = _jax_grads(jfn, (xj,), dy)
    before = _kernel_launches()
    _, (got_x,) = _torch_grads(tfn, (xt,), dy)
    assert _kernel_launches() == before          # plain versions on the CPU
    _close(got_x, want_x, TOL[policy], "dx")
    if trainable:
        got_w = wt.payload.grad
        assert got_w.dtype == wt.payload.dtype
        assert got_w.shape == wt.payload.shape
        _close(got_w, want_w.payload, TOL[policy], "dpayload")
    else:
        assert not wt.payload.requires_grad


@pytest.mark.parametrize("policy,payload", [
    ("bf16", "bfloat16"), ("fp32", "float32"), ("int8", "int8"),
    ("int8", "bfloat16")])
def test_sparse_weight_grads_match_jax_grad(policy, payload):
    """A float payload's cotangent is the dense gradient masked to the
    stored tiles (zero at the anchor zero tile); an int8 payload is
    frozen; dx contracts against the densified weight."""
    rng = np.random.default_rng(21)
    k, n = 100, 72
    np_dt, t_dt = X_DT[policy]
    x = _draw(rng, (6, k), bf16=policy != "fp32")
    w = _draw(rng, (k, n), 0.1)
    dy = rng.standard_normal((6, n)).astype(np.float32)
    keep = rng.random((4, 3)) < 0.5
    keep[:, 1] = False                            # an empty column
    keep[-1, -1] = True
    wj = js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep, dtype=payload)
    wt = ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                               dtype=payload)
    trainable = payload != "int8"
    xj, xt = _pair(x, np_dt, t_dt)

    def jfn(xx, ww=wj):
        return jax_mp_dot(xx, ww, policy=policy)

    if trainable:
        wt.payload.requires_grad_(True)
        want_x, want_w = _jax_grads(jfn, (xj, wj), dy)
    else:
        (want_x,) = _jax_grads(jfn, (xj,), dy)
    _, (got_x,) = _torch_grads(lambda xx: mp_dot(xx, wt, policy=policy),
                               (xt,), dy)
    _close(got_x, want_x, TOL[policy], "dx")
    if trainable:
        got_w = wt.payload.grad
        assert got_w.shape == wt.payload.shape
        assert not got_w[-1].float().abs().sum()   # the anchor zero tile
        _close(got_w, want_w.payload, TOL[policy], "dpayload")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 300, 100), (2, 96, 136),
                                   (64, 48, 20)])
def test_trans_a_plain_matches_reference_kernel(shape, dtype):
    """K1's plain version under ``trans_a`` (A read (K, M)) against the
    reference kernel in interpret mode, f32 and bf16 outputs, 2-D."""
    m, k, n = shape
    rng = np.random.default_rng(30)
    bf = dtype == "bfloat16"
    a = _draw(rng, (k, m), bf16=bf)
    b = _draw(rng, (k, n), bf16=bf)
    np_dt = ml_dtypes.bfloat16 if bf else np.float32
    t_dt = torch.bfloat16 if bf else torch.float32
    want = mpgemm_pallas(jnp.asarray(a.astype(np_dt)),
                         jnp.asarray(b.astype(np_dt)), trans_a=True,
                         out_dtype=jnp.float32, interpret=True)
    got = tk.mpgemm(torch.from_numpy(a).to(t_dt),
                    torch.from_numpy(b).to(t_dt),
                    spec=tspec.GemmSpec(trans_a=True),
                    out_dtype=torch.float32)
    assert got.shape == (m, n)
    _close(got, want, dict(atol=1e-4, rtol=1e-4), "trans_a")


def test_trans_a_grouped_plain_matches_reference_kernel():
    """The grouped ``trans_a`` (A (G, K, M)), bf16 operands, f32 out."""
    rng = np.random.default_rng(31)
    g, m, k, n = 3, 40, 17, 24
    a = _draw(rng, (g, k, m), bf16=True)
    b = _draw(rng, (g, k, n), bf16=True)
    bf = ml_dtypes.bfloat16
    want = mpgemm_grouped_pallas(jnp.asarray(a.astype(bf)),
                                 jnp.asarray(b.astype(bf)), trans_a=True,
                                 out_dtype=jnp.float32, interpret=True)
    got = tk.mpgemm_grouped(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16(),
                            spec=tspec.GemmSpec(grouped=True, trans_a=True),
                            out_dtype=torch.float32)
    assert got.shape == (g, m, n)
    _close(got, want, dict(atol=1e-4, rtol=1e-4), "grouped trans_a")


def test_backward_counts_no_launch_on_the_cpu():
    """A whole forward and backward on CPU tensors runs plain versions
    only: no kernel counter moves."""
    x = torch.randn(4, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    before = _kernel_launches()
    mp_dot(x, w, activation="silu").float().sum().backward()
    assert _kernel_launches() == before
    assert x.grad is not None and w.grad is not None
