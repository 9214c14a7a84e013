"""The port's gated cross-attention block (a VLM's ``cross`` kind,
``repro_torch.models.blocks``) against the JAX package's, on the CPU: over
a prompt (``cross_fwd``, its cached image K/V), at decode steps against
that cache (``cross_decode``), and its cache init.

The reference draws both gates as 0 (the block is then the identity) and
serves zero image embeddings; the tests draw the gates and the norm scales
with seeded numpy noise and the image embeddings non-zero, so a dropped
attention or MLP branch, or a K/V read from the wrong states, would show.
The JAX side runs its default CPU backend (XLA), whose attention rounds
the softmax weights to bf16 before P·V under bf16 where K4's plain
version keeps them in f32.

Tolerances: f32 atol = rtol = 1e-4; bf16 atol = rtol = 3e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2)}
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
ARCH = "llama-3.2-vision-11b"


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, policy):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[policy])


def _both(a, policy):
    jd, td = DT[policy]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _setup(policy, seed=0, gates=(0.7, -0.4)):
    jc, tc = jcb.get(ARCH, smoke=True), tcb.get(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JB.init_cross(jax.random.PRNGKey(seed), jc))
    for ln in ("ln1", "ln2"):
        tree[ln]["scale"] = (0.3 * rng.standard_normal(jc.d_model)).astype(
            np.float32)
    tree["gate_attn"] = np.float32(gates[0])
    tree["gate_mlp"] = np.float32(gates[1])

    def to_t(node):
        if isinstance(node, dict):
            return {k: to_t(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32))

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = LM(tc, policy=policy, device="cpu")._cast_layer(to_t(tree))
    img = rng.standard_normal((2, jc.n_image_tokens, jc.d_model))
    jimg, timg = _both(img, policy)
    jd, td = DT[policy]
    jctx = {"cfg": jc, "policy": policy, "collect_cache": True,
            "cache_dtype": jd, "cross_states": jimg}
    tctx = {"cfg": tc, "policy": policy, "fused": True,
            "collect_cache": True, "cache_dtype": td, "cross_states": timg}
    return jp, tp, jctx, tctx, rng


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_cross_block_prefill_and_decode(policy):
    jp, tp, jctx, tctx, rng = _setup(policy)
    d = jctx["cfg"].d_model
    xj, xt = _both(rng.standard_normal((2, 6, d)), policy)
    k4 = flash_attention.launches
    jy, _, jcache = JB.cross_fwd(jp, xj, jctx)
    ty, aux, tcache = TB.cross_fwd(tp, xt, tctx)
    assert flash_attention.launches == k4      # CPU: the plain version
    assert aux == 0.0 and ty.dtype == xt.dtype
    _close(ty, jy, policy)
    for key in ("k", "v"):
        assert tcache[key].shape == (2, tctx["cfg"].n_kv_heads,
                                     tctx["cfg"].n_image_tokens,
                                     tctx["cfg"].head_dim)
        assert tcache[key].dtype == DT[policy][1]
        _close(tcache[key], jcache[key], policy)
    # Decode reads the cached K/V, never the image states again.
    jctx.pop("cross_states")
    tctx.pop("cross_states")
    for _ in range(2):
        xj, xt = _both(rng.standard_normal((2, 1, d)), policy)
        jy, jcache = JB.cross_decode(jp, xj, jcache, jctx)
        ty = TB.cross_decode(tp, xt, tcache, tctx)
        _close(ty, jy, policy)


def test_cross_block_gates_scale_each_branch():
    """Zero gates make the block the identity, as the reference's init;
    each non-zero gate moves the output."""
    jp, tp, jctx, tctx, rng = _setup("fp32", gates=(0.0, 0.0))
    d = tctx["cfg"].d_model
    xt = torch.from_numpy(rng.standard_normal((2, 3, d)).astype(np.float32))
    y, _, _ = TB.cross_fwd(tp, xt, tctx)
    assert torch.equal(y, xt)
    for gate in ("gate_attn", "gate_mlp"):
        y, _, _ = TB.cross_fwd(dict(tp, **{gate: torch.tensor(0.5)}), xt,
                               tctx)
        assert (y - xt).abs().max() > 1e-3


def test_cross_init_cache():
    jc, tc = jcb.get(ARCH, smoke=True), tcb.get(ARCH, smoke=True)
    want = JB.cross_init_cache(jc, 3, 20, jnp.bfloat16)
    got = TB.cross_init_cache(tc, 3, 20, torch.bfloat16, device="cpu")
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.bfloat16 and not got[key].any()


def test_init_cross_leaves():
    jc, tc = jcb.get(ARCH, smoke=True), tcb.get(ARCH, smoke=True)
    want = jax.tree_util.tree_map(np.asarray,
                                  JB.init_cross(jax.random.PRNGKey(0), jc))
    got = TB.init_cross(tc, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert set(got) == set(want)
    for key in ("gate_attn", "gate_mlp"):
        assert got[key].shape == () and float(got[key]) == 0.0
    for key in ("xattn", "mlp", "ln1", "ln2"):
        assert {k: tuple(v.shape) for k, v in got[key].items()} == \
            {k: v.shape for k, v in want[key].items()}
