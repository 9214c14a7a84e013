"""Training the cross and recurrent kinds in the port against the JAX
package, block by block, on the CPU: the gradients of ``cross_fwd`` (a
VLM's gated cross-attention block), ``rwkv_fwd`` (RWKV-6) and
``rglru_fwd`` (RecurrentGemma's Griffin block) against ``jax.grad`` of
the reference's, under fp32, bf16 and int8; the recurrences' per-chunk
rematerialisation (``models/recurrent.py::_chunk_scan``); AdamW's decay
mask over the three smoke patterns; and ``chip_smoke.py``'s parameter
count, which sizes its checkpoints.

Each block's parameters are the reference's draw with seeded noise on
every constant leaf (``torch_wave_forms.perturbed``) and the cross gates
set to 0.7 and -0.4: at the drawn gates (0) every gradient of the cross
block's attention and MLP is exactly zero.  The loss is the f32 sum of
the block's squared outputs, each weighted by a fixed random weight in
[0.5, 1.5] (a sum of positive terms, which no rounding cancels).  ``CHUNK`` is 8 in
both packages and T = 20, so two full chunks run rematerialised and a
tail of 4 runs unchecked (under int8 T = 12: one chunk and the tail, as
the reference's op-by-op run takes a second or two a step).  The reference runs on its ``xla`` backend (the
one whose attention differentiates); under int8 op by op
(``jax.disable_jit()``): jitted, XLA folds its per-tensor scale's
division by 127 into a multiplication and moves int8 roundings (ROADMAP
C).

Tolerances.  fp32: each gradient leaf atol 1e-5 + rtol 1e-3 of the leaf's
largest |g| (``test_torch_train.py::_close_rel``: a gradient sums many
products in another order), the loss rtol 1e-5.  bf16 and int8: the loss
within 2 % and the gradient norm within 10 %, as the whole training step
is held (``test_torch_train.py::test_train_step_runs_under_bf16_and_int8``):
the reference's xla backward sums in bf16, the port's kernels in f32.
"""
import contextlib
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.launch.train import cut_layers  # noqa: E402
from repro_torch.models import blocks as TB  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.optim.adamw import decay_mask, tree_leaves  # noqa: E402
from torch_wave_forms import perturbed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = {"cross": ("llama-3.2-vision-11b", JB.init_cross, JB.cross_fwd,
                   TB.cross_fwd),
         "rwkv": ("rwkv6-1.6b", JR.init_rwkv, JR.rwkv_fwd, TR.rwkv_fwd),
         "rglru": ("recurrentgemma-2b", JR.init_rglru, JR.rglru_fwd,
                   TR.rglru_fwd)}
ACT = {"fp32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "int8": (jnp.bfloat16, torch.bfloat16)}
B, CHUNK = 2, 8
T = {"fp32": 20, "bf16": 20, "int8": 12}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _setup(kind, policy, seed=0):
    """One block of ``kind``: (reference params, port f32 master params,
    reference ctx, port ctx, x as numpy f32 rounded to the activation
    dtype, the loss's weights)."""
    arch, init, _, _ = KINDS[kind]
    jc, tc = jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)
    tree = perturbed(jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(seed), jc)), seed)
    if kind == "cross":
        tree["gate_attn"], tree["gate_mlp"] = np.float32(0.7), np.float32(-0.4)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = {}
    for path, leaf in _paths(tree):
        node = tp
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(
            np.array(leaf, np.float32)).requires_grad_(True)
    rng = np.random.default_rng(seed + 1)
    jd, td = ACT[policy]
    t = T[policy]
    x = np.array(jnp.asarray(rng.standard_normal(
        (B, t, jc.d_model)), jd).astype(jnp.float32))
    ct = rng.uniform(0.5, 1.5, (B, t, jc.d_model)).astype(np.float32)
    jctx = {"cfg": jc, "policy": policy, "collect_cache": False,
            "cache_dtype": jd}
    tctx = {"cfg": tc, "policy": policy, "fused": True,
            "collect_cache": False, "cache_dtype": td}
    if kind == "cross":
        img = np.array(jnp.asarray(rng.standard_normal(
            (B, jc.n_image_tokens, jc.d_model)), jd).astype(jnp.float32))
        jctx["cross_states"] = jnp.asarray(img, jd)
        tctx["cross_states"] = torch.from_numpy(img).to(td)
    return jp, tp, jctx, tctx, x, ct


def _both(kind, policy, monkeypatch):
    """-> ((loss, {path: grad}) of the reference, the same of the port);
    the input's gradient under the path ("x",)."""
    monkeypatch.setattr(JR, "CHUNK", CHUNK)
    monkeypatch.setattr(TR, "CHUNK", CHUNK)
    _, _, jfwd, tfwd = KINDS[kind]
    jp, tp, jctx, tctx, x, ct = _setup(kind, policy)
    jd, td = ACT[policy]

    def jloss(p, xx):
        out = jfwd(p, xx, jctx)[0]
        return jnp.sum(jnp.square(out.astype(jnp.float32)) * ct)

    eager = (jax.disable_jit() if policy == "int8"
             else contextlib.nullcontext())
    with jcfg.gemm_backend("xla"), eager:
        fn = jax.value_and_grad(jloss, argnums=(0, 1))
        if policy != "int8":
            fn = jax.jit(fn)
        jl, (jg, jgx) = fn(jp, jnp.asarray(x, jd))
    want = {p: np.asarray(g, np.float32) for p, g in _paths(jg)}
    want[("x",)] = np.asarray(jgx.astype(jnp.float32))

    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    out = tfwd(tp, tx, tctx)[0]
    tl = (torch.square(out.float()) * torch.from_numpy(ct)).sum()
    leaves = [leaf for _, leaf in _paths(tp)]
    grads = torch.autograd.grad(tl, leaves + [tx])
    got = {p: g.float().numpy() for (p, _), g in zip(_paths(tp), grads)}
    got[("x",)] = grads[-1].float().numpy()
    return (float(jl), want), (float(tl.detach()), got)


def _norm(grads):
    return float(np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                             for g in grads.values())))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_gradients_match_jax_grad_fp32(kind, monkeypatch):
    (jl, want), (tl, got) = _both(kind, "fp32", monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        err = np.abs(g - w).max() if g.size else 0.0
        bound = 1e-5 + 1e-3 * np.abs(w).max()
        assert err <= bound, f"d{path}: max err {err:.3e} > {bound:.3e}"
    if kind == "cross":           # the gates open both branches
        for name in ("wq", "wk", "wv", "wo"):
            assert np.abs(got[("xattn", name)]).max() > 0
        assert np.abs(got[("gate_attn",)]) > 0
        assert np.abs(got[("gate_mlp",)]) > 0


@pytest.mark.parametrize("policy", ["bf16", "int8"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_gradients_under_bf16_and_int8(kind, policy, monkeypatch):
    (jl, want), (tl, got) = _both(kind, policy, monkeypatch)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    np.testing.assert_allclose(_norm(got), _norm(want), rtol=0.1)
    assert all(np.isfinite(g).all() for g in got.values())


# --- the chunked scan's rematerialisation ------------------------------------

def _scan_before(step_fn, state, xs, chunk):
    """``_chunk_scan`` as it ran before its chunks were rematerialised: a
    plain loop, chunk by chunk, the tail unpadded."""
    t = xs[0].shape[0]
    parts = []
    for start in range(0, t, min(chunk, t)):
        ys = []
        for i in range(start, min(start + chunk, t)):
            state, y = step_fn(state, tuple(a[i] for a in xs))
            ys.append(y)
        parts.append(torch.stack(ys))
    return state, torch.cat(parts) if len(parts) > 1 else parts[0]


def _saved_states(fn, state_shape):
    """The tensors of ``state_shape`` that autograd saves while ``fn()``
    runs."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(s == state_shape for s in shapes)


@pytest.mark.parametrize("kind", ["rwkv", "rglru"])
def test_recurrent_forward_saves_a_state_a_chunk(kind, monkeypatch):
    """Under grad, a recurrent layer's forward (T 16, chunk 4) saves its
    state at each chunk's boundary: T / chunk = 4 tensors of the state's
    shape, where a plain loop saves at least one a step (16).  With grad
    off the scan gives the bits the plain loop gives."""
    monkeypatch.setattr(TR, "CHUNK", 4)
    arch, _, _, tfwd = KINDS[kind]
    cfg = tcb.get(arch, smoke=True)
    layer = tbuild(cfg, policy="fp32", device="cpu").init_train(
        torch.Generator().manual_seed(0))["layers"][0]
    for leaf in tree_leaves(layer):
        leaf.requires_grad_(True)
    x = torch.randn(1, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)).requires_grad_(True)
    ctx = {"cfg": cfg, "policy": "fp32", "fused": True,
           "collect_cache": False}
    if kind == "rwkv":
        dh = cfg.rwkv_head_dim
        state = (1, cfg.d_model // dh, dh, dh)
    else:
        state = (1, cfg.lru_width or cfg.d_model)
    remat = _saved_states(lambda: tfwd(layer, x, ctx), state)
    monkeypatch.setattr(TR, "checkpoint",
                        lambda fn, *args, **kw: fn(*args))
    plain = _saved_states(lambda: tfwd(layer, x, ctx), state)
    assert remat <= 16 // 4 < 16 <= plain, (remat, plain)

    # Grad off: the bits of the plain loop, tail included.
    rng = np.random.default_rng(2)
    xs = tuple(torch.from_numpy(rng.standard_normal((18, 3, 5)).astype(
        np.float32)) for _ in range(2))
    h0 = torch.zeros(3, 5)

    def step(h, inp):
        h = torch.tanh(inp[0]) * h + inp[1]
        return h, h * 2.0

    want = _scan_before(step, h0, xs, 4)
    xs = tuple(a.requires_grad_(True) for a in xs)
    with torch.no_grad():
        got = TR._chunk_scan(step, h0, xs, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(TR._chunk_scan(step, h0, xs, 4), want):   # and under
        assert torch.equal(g.detach(), w)                       # grad


# --- the CLI's depth cut, AdamW's decay mask, chip_smoke.py's count ------

@pytest.mark.parametrize("arch,n,want", [
    ("llama-3.2-vision-11b", 5, ("dense",) * 4 + ("cross",)),
    ("rwkv6-1.6b", 4, ("rwkv",) * 4),
    ("recurrentgemma-2b", 5, ("rglru", "rglru", "attn_local", "rglru",
                              "rglru"))])
def test_cli_layers_cut_keeps_the_pattern(arch, n, want):
    """``--layers N`` (``launch/train.py::cut_layers``) keeps the first N
    layers of each full-size pattern, as ``chip_smoke.py``'s training
    paths use them."""
    cfg = cut_layers(tcb.get(arch), n)
    assert cfg.pattern == want and cfg.n_layers == n
    assert cfg.d_model == tcb.get(arch).d_model


@pytest.mark.parametrize("arch", sorted(a for a, *_ in KINDS.values()))
def test_decay_mask_matches_the_reference(arch):
    """The port's per-layer ``decay_mask`` equals the reference's rule
    (decay a leaf of rank >= 2 in its stacked tree) leaf for leaf:
    llama-vision's (dense x 4, cross) unit, rwkv6's all-stacked layers,
    recurrentgemma's (rglru, rglru, attn_local) unit and (rglru, rglru)
    tail, whose 1-D leaves are not decayed."""
    jc, tc = jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)
    shapes = jax.eval_shape(jbuild(jc, policy="fp32").init,
                            jax.random.PRNGKey(0))
    ranks = jax.tree_util.tree_map(
        lambda p: np.full(p.shape, len(p.shape) >= 2, np.float32), shapes)
    want = params_from_jax(ranks, tc)
    got = decay_mask(tbuild(tc, policy="fp32", device="cpu").init_train(
        torch.Generator().manual_seed(0)), tc)
    flat_w = dict(_paths(want))
    flat_g = dict(_paths(got))
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        assert flat_g[path] == bool(w.all()), path
    if tc.pattern[-1] == "rglru" and len(tc.pattern) == 5:   # the tail
        assert flat_g[("layers", 4, "ln1", "scale")] is False
        assert flat_g[("layers", 0, "ln1", "scale")] is True


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "rwkv6-1.6b",
                                  "recurrentgemma-2b", "phi3-mini-3.8b",
                                  "granite-moe-1b-a400m"])
def test_chip_smoke_counts_the_parameters_it_checkpoints(arch):
    """``chip_smoke.py::_n_params`` (which sizes phase_train's checkpoint
    directory) counts the leaves ``LM.init_train`` draws, on the smoke
    model and on the first layers of each kind's pattern."""
    cs = _chip_smoke()
    cfg = tcb.get(arch, smoke=True)
    for n in (len(cfg.pattern), 3):
        cut = cut_layers(cfg, n)
        params = tbuild(cut, policy="bf16", device="cpu").init_train(
            torch.Generator().manual_seed(0))
        assert cs._n_params(cut) == sum(p.numel()
                                        for p in tree_leaves(params))
