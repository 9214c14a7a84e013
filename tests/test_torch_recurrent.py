"""The port's recurrent blocks (``repro_torch.models.recurrent``) against
the JAX package's (``repro.models.recurrent``), function by function, on
the CPU: the chunked scan (a tail shorter than a chunk), the token shift,
one WKV step, RWKV-6's time and channel mix, whole layers and their
decode, the causal conv, the RG-LRU scan, and RecurrentGemma's Griffin
block; a prefill followed by decode steps against one longer prefill.

The reference draws many leaves as constants (the lerp bases 0.5, the
decay base -6, the group-norm scale 1, the norm scales 0, lambda 2, the
conv bias 0); the tests add seeded numpy noise to every one of them in the
tree both packages load, so a swapped mix stream (r, k, v, w, g) or a
dropped scale would show.  The JAX side runs its default CPU backend.

Tolerances: f32 atol = rtol = 1e-4 (summation order only); bf16 atol =
rtol = 3e-2 (every GEMM output rounded to bf16 in both, one bf16 ulp is
2**-8 at 1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2)}
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# The reference's constant leaves and the noise each gets.
NOISE = {"mu": 0.2, "mu_c": 0.2, "w_base": 1.0, "gn_scale": 0.3,
         "scale": 0.3, "lambda_p": 0.5, "conv_b": 0.3}


def perturb(tree, seed):
    """The tree (numpy leaves) with seeded noise on each constant leaf."""
    rng = np.random.default_rng(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if name in NOISE:
            noise = NOISE[name] * rng.standard_normal(np.shape(node))
            return (np.asarray(node) + noise).astype(np.float32)
        return node

    return walk(tree)


def _cfg(arch):
    return jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)


def _params(kind, seed=0):
    """One layer's reference params (perturbed) as (jax tree, torch tree);
    the port's carry the policy's load-time casts (``LM._cast_layer``)."""
    jc, tc = _cfg("rwkv6-1.6b" if kind == "rwkv" else "recurrentgemma-2b")
    init = JR.init_rwkv if kind == "rwkv" else JR.init_rglru
    tree = perturb(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(seed), jc)), seed)

    def to_t(node):
        if isinstance(node, dict):
            return {k: to_t(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32))

    return (jax.tree_util.tree_map(jnp.asarray, tree), to_t(tree), jc, tc)


def _x(shape, policy, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DT[policy]
    xj = jnp.asarray(x, jd)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, policy):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[policy])


def _ctx(jc, tc, policy, collect=False):
    dt = DT[policy]
    return ({"cfg": jc, "policy": policy, "collect_cache": collect,
             "cache_dtype": dt[0]},
            {"cfg": tc, "policy": policy, "fused": True,
             "collect_cache": collect, "cache_dtype": dt[1]})


def _cast(tp, tc, policy):
    return LM(tc, policy=policy, device="cpu")._cast_layer(tp)


# ================================ scan ======================================

@pytest.mark.parametrize("t", [5, 128, 130, 259])
def test_chunk_scan_runs_the_tail_unpadded(t):
    """A decaying sum over T steps (T not a multiple of the chunk, and
    T < chunk) gives the reference's outputs and final state; a padded
    tail would decay the state further."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, (t, 3)).astype(np.float32)
    x = rng.standard_normal((t, 3)).astype(np.float32)

    def jstep(h, inp):
        h = inp[0] * h + inp[1]
        return h, 2.0 * h

    def tstep(h, inp):
        h = inp[0] * h + inp[1]
        return h, 2.0 * h

    h0 = np.ones(3, np.float32)
    js, jy = JR._chunk_scan(jstep, jnp.asarray(h0),
                            (jnp.asarray(a), jnp.asarray(x)), JR.CHUNK)
    ts, ty = TR._chunk_scan(tstep, torch.from_numpy(h0),
                            (torch.from_numpy(a), torch.from_numpy(x)),
                            TR.CHUNK)
    assert TR.CHUNK == JR.CHUNK == 128
    assert ty.shape == (t, 3)
    _close(ts, js, "fp32")
    _close(ty, jy, "fp32")


def test_token_shift_and_wkv_step():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    prev = rng.standard_normal((2, 8)).astype(np.float32)
    _close(TR._token_shift(torch.from_numpy(x), torch.from_numpy(prev)),
           JR._token_shift(jnp.asarray(x), jnp.asarray(prev)), "fp32")
    state = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    r, k, v = (rng.standard_normal((2, 3, 4)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0, 1, (2, 3, 4)).astype(np.float32)
    u = rng.standard_normal((3, 4)).astype(np.float32)
    args = (r, k, v, w, u)
    js, jo = JR._wkv_step(jnp.asarray(state),
                          tuple(jnp.asarray(a) for a in args))
    ts, to = TR._wkv_step(torch.from_numpy(state),
                          tuple(torch.from_numpy(a) for a in args))
    _close(ts, js, "fp32")
    _close(to, jo, "fp32")


# ================================ RWKV-6 ====================================

@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_rwkv_time_and_channel_mix(policy):
    jp, tp, jc, tc = _params("rwkv")
    tp = _cast(tp, tc, policy)
    b, t, d = 2, 7, jc.d_model
    xj, xt = _x((b, t, d), policy)
    sj, st = _x((b, d), policy, seed=2)
    h, dh = d // jc.rwkv_head_dim, jc.rwkv_head_dim
    state = 0.1 * np.random.default_rng(4).standard_normal(
        (b, h, dh, dh)).astype(np.float32)
    g0 = mpgemm_grouped.launches
    want = JR.rwkv_time_mix(jp, xj, sj, jnp.asarray(state), jc, policy)
    got = TR.rwkv_time_mix(tp, xt, st, torch.from_numpy(state), tc, policy)
    assert mpgemm_grouped.launches == g0     # CPU: plain versions only
    for g, w in zip(got, want):
        _close(g, w, policy)
    want = JR.rwkv_channel_mix(jp, xj, sj, policy)
    got = TR.rwkv_channel_mix(tp, xt, st, policy)
    for g, w in zip(got, want):
        _close(g, w, policy)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_rwkv_layer_prefill_then_decode(policy):
    """rwkv_fwd over a prompt (its cache), then decode steps in place,
    against the reference; and the decode's outputs against one longer
    prefill (the state carries the whole prefix)."""
    jp, tp, jc, tc = _params("rwkv", seed=1)
    tp = _cast(tp, tc, policy)
    jctx, tctx = _ctx(jc, tc, policy, collect=True)
    b, t, n, d = 2, 6, 3, jc.d_model
    xj, xt = _x((b, t + n, d), policy, seed=5)
    jy, _, jcache = JR.rwkv_fwd(jp, xj[:, :t], jctx)
    ty, _, tcache = TR.rwkv_fwd(tp, xt[:, :t], tctx)
    _close(ty, jy, policy)
    for key in ("state", "shift_t", "shift_c"):
        assert tcache[key].dtype == (torch.float32 if key == "state"
                                     else DT[policy][1])
        _close(tcache[key], jcache[key], policy)
    long_y, _, _ = TR.rwkv_fwd(tp, xt, dict(tctx, collect_cache=False))
    ids = {k: v.data_ptr() for k, v in tcache.items()}
    for i in range(t, t + n):
        jyi, jcache = JR.rwkv_decode(jp, xj[:, i:i + 1], jcache, jctx)
        tyi = TR.rwkv_decode(tp, xt[:, i:i + 1], tcache, tctx)
        _close(tyi, jyi, policy)
        _close(tyi, long_y[:, i:i + 1], policy)
    assert ids == {k: v.data_ptr() for k, v in tcache.items()}
    for key in tcache:
        _close(tcache[key], jcache[key], policy)


def test_rwkv_init_cache_shapes():
    jc, tc = _cfg("rwkv6-1.6b")
    want = JR.rwkv_init_cache(jc, 3, 20, jnp.bfloat16)
    got = TR.rwkv_init_cache(tc, 3, 20, torch.bfloat16, device="cpu")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


# ================================ RG-LRU ====================================

@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_causal_conv(policy):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    xj, xt = _x((2, 9, 16), policy, seed=7)
    sj, st = _x((2, 3, 16), policy, seed=8)
    for state in ((None, None), (sj, st)):
        want = JR._causal_conv(xj, jnp.asarray(w), jnp.asarray(bias),
                               state[0])
        got = TR._causal_conv(xt, torch.from_numpy(w), torch.from_numpy(bias),
                              state[1])
        for g, v in zip(got, want):
            assert g.dtype == xt.dtype
            _close(g, v, policy)


@pytest.mark.parametrize("t", [9, 130])
def test_rglru_scan(t):
    """Both gates on the fp32 policy; 130 steps run a chunk and a tail."""
    jp, tp, jc, tc = _params("rglru")
    w = jc.lru_width
    uj, ut = _x((2, t, w), "bf16", seed=9)
    h0 = np.random.default_rng(10).standard_normal((2, w)).astype(np.float32)
    k1 = mpgemm.launches
    want = JR.rglru_scan(jp, uj, jnp.asarray(h0))
    got = TR.rglru_scan(tp, ut, torch.from_numpy(h0))
    assert mpgemm.launches == k1
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    _close(got[0], want[0], "bf16")
    _close(got[1], want[1], "fp32")


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_rglru_layer_prefill_then_decode(policy):
    jp, tp, jc, tc = _params("rglru", seed=2)
    tp = _cast(tp, tc, policy)
    jctx, tctx = _ctx(jc, tc, policy, collect=True)
    b, t, n, d = 2, 6, 3, jc.d_model
    xj, xt = _x((b, t + n, d), policy, seed=11)
    jy, _, jcache = JR.rglru_fwd(jp, xj[:, :t], jctx)
    ty, _, tcache = TR.rglru_fwd(tp, xt[:, :t], tctx)
    _close(ty, jy, policy)
    assert tcache["h"].dtype == torch.float32
    assert tcache["conv"].dtype == DT[policy][1]
    for key in ("h", "conv"):
        _close(tcache[key], jcache[key], policy)
    long_y, _, _ = TR.rglru_fwd(tp, xt, dict(tctx, collect_cache=False))
    for i in range(t, t + n):
        jyi, jcache = JR.rglru_decode(jp, xj[:, i:i + 1], jcache, jctx)
        tyi = TR.rglru_decode(tp, xt[:, i:i + 1], tcache, tctx)
        _close(tyi, jyi, policy)
        _close(tyi, long_y[:, i:i + 1], policy)
    for key in tcache:
        _close(tcache[key], jcache[key], policy)


def test_rglru_gate_gelu_is_tanh():
    """The gate branch's GELU is jax.nn.gelu's tanh form: with the exact
    erf GELU the block's output moves."""
    jp, tp, jc, tc = _params("rglru", seed=3)
    _, tctx = _ctx(jc, tc, "fp32")
    xj, xt = _x((1, 4, jc.d_model), "fp32", seed=12)
    want, _, _ = JR.rglru_fwd(jp, xj, _ctx(jc, tc, "fp32")[0])
    got, _, _ = TR.rglru_fwd(tp, xt, tctx)
    _close(got, want, "fp32")
    acts = dict(TR.ACTIVATIONS)
    try:
        TR.ACTIVATIONS["gelu"] = torch.nn.functional.gelu
        exact, _, _ = TR.rglru_fwd(tp, xt, tctx)
    finally:
        TR.ACTIVATIONS.clear()
        TR.ACTIVATIONS.update(acts)
    assert (exact - got).abs().max() > 1e-6


def test_rglru_init_cache_shapes():
    jc, tc = _cfg("recurrentgemma-2b")
    want = JR.rglru_init_cache(jc, 2, 20, jnp.bfloat16)
    got = TR.rglru_init_cache(tc, 2, 20, torch.bfloat16, device="cpu")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


def test_init_leaves_match_the_reference():
    """The port's draws have the reference's leaves, shapes and constant
    values."""
    for kind, arch in (("rwkv", "rwkv6-1.6b"), ("rglru",
                                                "recurrentgemma-2b")):
        jc, tc = _cfg(arch)
        init_j = JR.init_rwkv if kind == "rwkv" else JR.init_rglru
        init_t = TR.init_rwkv if kind == "rwkv" else TR.init_rglru
        want = jax.tree_util.tree_map(np.asarray,
                                      init_j(jax.random.PRNGKey(0), jc))
        got = init_t(tc, generator=torch.Generator().manual_seed(0),
                     device="cpu")

        def walk(g, w, path=()):
            assert set(g) == set(w), path
            for k in w:
                if isinstance(w[k], dict):
                    walk(g[k], w[k], path + (k,))
                    continue
                assert tuple(g[k].shape) == w[k].shape, path + (k,)
                assert g[k].dtype == torch.float32
                if np.all(w[k] == w[k].flat[0]):          # a constant leaf
                    assert torch.all(g[k] == float(w[k].flat[0])), k

        walk(got, want)


def test_pattern_segments_like_the_reference():
    """recurrentgemma stacks a unit of 3 with a remainder of 2, llama-vision
    a unit of 5: the port unstacks the reference's layers in that order."""
    from repro.models.transformer import segment_pattern as jseg
    for arch in ("recurrentgemma-2b", "llama-3.2-vision-11b"):
        for smoke in (False, True):
            jc = jcb.get(arch, smoke=smoke)
            assert tcb.segment_pattern(tcb.get(arch, smoke=smoke).pattern) \
                == jseg(jc.pattern)
    unit, n, rem = tcb.segment_pattern(
        tcb.get("recurrentgemma-2b").pattern)
    assert (len(unit), n, len(rem)) == (3, 8, 2)
    unit, n, rem = tcb.segment_pattern(
        tcb.get("llama-3.2-vision-11b").pattern)
    assert (len(unit), n, len(rem)) == (5, 8, 0)
    assert dataclasses.is_dataclass(tcb.get("rwkv6-1.6b"))
