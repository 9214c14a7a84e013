"""Helpers of ``tests/test_torch_wave_forms_{int8,packed,sparse}.py``: the
cross and recurrent architectures (llama-3.2-vision-11b, rwkv6-1.6b,
recurrentgemma-2b) at their smoke sizes, served in another form than
dense bf16 by both packages from one parameter tree.

The reference draws many leaves as constants (norm scales 0, RWKV's lerp
bases 0.5, decay base -6 and group-norm scale 1, RG-LRU's lambda 2 and
conv bias 0, the cross gates 0) and its engine serves zero image
embeddings; :func:`pair` adds seeded numpy noise to every such leaf before
it packs or sparsifies the tree (``repro.packing.pack_params``,
``repro.sparse.sparsify_params``), and the prompts carry non-zero image
embeddings, so a dropped scale or a closed cross branch would show.
``params_from_jax`` carries the tree across, payload bytes unchanged.

Where the reference's int8 policy is involved, :func:`run_both` runs it
op by op (``jax.disable_jit()``): jitted, XLA folds its per-tensor
scale's division by 127 into a multiplication by 1/127, which moves the
scale by an ulp in about one tensor in twenty, and a moved scale flips
int8 roundings that the next layers carry to the logits.  Op by op, each
of its ops is the IEEE operation it names, as the port's are.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.packing import pack_params as jpack  # noqa: E402
from repro.sparse import sparsify_params as jsparsify  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.sparse import TileSparseOperand  # noqa: E402

ARCHS = ["llama-3.2-vision-11b", "rwkv6-1.6b", "recurrentgemma-2b"]
# Each constant leaf of the reference's init and the noise it gets here.
NOISE = {"scale": 0.3, "mu": 0.2, "mu_c": 0.2, "w_base": 1.0,
         "gn_scale": 0.3, "lambda_p": 0.5, "conv_b": 0.3, "gate_attn": 1.0,
         "gate_mlp": 1.0}
# The sparse forms' lattice: the smoke models' 128-wide weights hold 16
# tiles of 32 x 32 (one 128 x 128 tile would leave nothing to prune).
SPARSE_BLOCKS = (32, 32)
# Logits atol = rtol = 3e-2, as the packed and sparse serving tests hold:
# both packages round every GEMM output and the residual stream to bf16,
# and a bf16 ulp at the logits' scale (about 1) is 2**-8.
TOL = dict(atol=3e-2, rtol=3e-2)


def perturbed(tree, seed):
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


def transform(jp, policy, form):
    """The reference's tree in ``form``: None (dense), ("pack", payload
    format or None for the policy's) or ("sparse", method[, blocks]) at
    50 % on ``blocks`` (default :data:`SPARSE_BLOCKS`; N:M keeps 2 of
    every 4 k-tiles)."""
    if form is None:
        return jp
    if form[0] == "pack":
        return jpack(jp, policy=policy, pack_format=form[1])
    blocks = form[2] if len(form) > 2 else SPARSE_BLOCKS
    return jsparsify(jp, density=0.5, method=form[1], nm=(2, 4),
                     policy=policy, blocks=blocks)


@functools.lru_cache(maxsize=None)
def _reference(arch, policy, seed):
    jm = jbuild(jcb.get(arch, smoke=True), policy=policy, remat=False)
    tree = perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed))), seed)
    return jm, tree


def pair(arch, policy, form=None, seed=0):
    """-> (reference model, its params in ``form``, port model, its params
    carried across, the perturbed dense tree with numpy leaves)."""
    jm, tree = _reference(arch, policy, seed)
    jp = transform(jax.tree_util.tree_map(jnp.asarray, tree), policy, form)
    tm = tbuild(tcb.get(arch, smoke=True), policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tm.cfg))
    return jm, jp, tm, tp, tree


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def operands(tree, cls=(PackedOperand, TileSparseOperand)):
    return [v for v in leaves(tree) if isinstance(v, cls)]


def prompts(cfg, s, n, seed=1):
    """(tokens (2, s + n), image embeddings or None): row 1 left-padded."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (2, s + n)).astype(np.int32)
    toks[1, :3] = 0
    img = None
    if cfg.family == "vlm":
        img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)
                                  ).astype(np.float32)
    return toks, img


def _batches(toks, img):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if img is not None:
        jb["image_embeds"] = jnp.asarray(img)
        tb["image_embeds"] = torch.from_numpy(img)
    return jb, tb


def port_logits(logits, cfg):
    return logits.float().numpy()[:, :cfg.vocab]


def ref_logits(logits, cfg):
    return np.asarray(logits.astype(jnp.float32))[:, :cfg.vocab]


def run_both(jm, jp, tm, tp, *, s=8, n=2, backend="xla", eager=False,
             max_len=16):
    """A prefill of ``s`` tokens then ``n`` decode steps in both packages
    (the reference on ``backend``, jitted, or op by op when ``eager``)
    -> (pairs of (port, reference) logits over the real vocab, the port's
    caches, the reference's caches, tokens, image embeddings)."""
    cfg = tm.cfg
    toks, img = prompts(cfg, s, n)
    jb, tb = _batches(toks[:, :s], img)
    no_jit = jax.disable_jit() if eager else contextlib.nullcontext()
    with jcfg.gemm_backend(backend), no_jit:
        jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(
            jp, jb)
        tl, tc = tm.prefill(tp, tb, max_len=max_len)
        pairs = [(port_logits(tl, cfg), ref_logits(jl, cfg))]
        dec = jax.jit(jm.decode_step)
        for i in range(n):
            tok = toks[:, s + i:s + i + 1]
            jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.int32(s + i))
            tl, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc, s + i)
            assert tc2 is tc
            pairs.append((port_logits(tl, cfg), ref_logits(jl, cfg)))
    return pairs, tc, jc, toks, img


def assert_pairs_close(pairs, tol=TOL):
    for got, want in pairs:
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, **tol)


def longer_prefill(tm, tp, toks, img, max_len=16):
    """The port's logits after one prefill of every token of ``toks``."""
    _, tb = _batches(toks, img)
    logits, _ = tm.prefill(tp, tb, max_len=max_len)
    return port_logits(logits, tm.cfg)


def cache_leaves(tc, jc, cfg):
    """(port tensor, reference array, path) of every cache tensor, the
    reference's stacked caches sliced per layer."""
    from repro_torch.configs.base import segment_pattern
    unit, n_units, rem = segment_pattern(cfg.pattern)
    out = []

    def walk(t, j, path):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], j[k], path + (k,))
        else:
            out.append((t, j, path))

    for i, layer in enumerate(tc):
        u, p = divmod(i, len(unit))
        if u < n_units:
            ref = jax.tree_util.tree_map(lambda a, u=u: a[u], jc["stack"][p])
        else:
            ref = jc["tail"][i - n_units * len(unit)]
        walk(layer, ref, (i,))
    return out


@dataclasses.dataclass
class Call:
    """One GEMM wrapper call of ``core/gemm.py``: the kernel its operand
    form selects ("k1", "k2", "k3"), grouped, A's dtype, f32 FMA asked."""
    kernel: str
    grouped: bool
    a_dtype: torch.dtype
    f32_fma: bool


def record_calls(monkeypatch):
    """Record every GEMM wrapper call (``Call``) and K4 call ("k4") the
    model makes through ``core/gemm.py`` and ``models/attention.py``."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.models import attention as attn_mod
    calls = []

    def gemm(inner, grouped):
        def call(a, b, *, spec, **kw):
            kernel = ("k2" if isinstance(b, PackedOperand) else
                      "k3" if isinstance(b, TileSparseOperand) else "k1")
            calls.append(Call(kernel, grouped, a.dtype,
                              kw.get("f32_fma", False)))
            return inner(a, b, spec=spec, **kw)
        return call

    monkeypatch.setattr(gemm_mod, "mpgemm", gemm(gemm_mod.mpgemm, False))
    monkeypatch.setattr(gemm_mod, "mpgemm_grouped",
                        gemm(gemm_mod.mpgemm_grouped, True))
    attention = attn_mod.flash_attention

    def flash(q, k, v, **kw):
        calls.append("k4")
        return attention(q, k, v, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", flash)
    return calls


def tally(calls, fmt=None):
    """The recorded calls in ``chip_smoke._want_wave_launches``' keys."""
    out = dict(k1=0, k1_fma=0, k1g=0, k1g_fma=0, k4=0)
    if fmt:
        out.update({fmt: 0, f"{fmt}g": 0, f"{fmt}_f32": 0})
    for c in calls:
        if c == "k4":
            out["k4"] += 1
            continue
        key = c.kernel + ("g" if c.grouped else "")
        out[key] += 1
        if c.kernel == "k1" and c.f32_fma:
            out[key + "_fma"] += 1
        if c.kernel != "k1" and c.a_dtype == torch.float32:
            out[f"{c.kernel}_f32"] += 1
    return out


def chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_counts(monkeypatch, tm, tp, fmt=None):
    """One wave prefill and one decode step of the smoke model: the wrapper
    calls number what ``chip_smoke.py``'s ``_want_wave_launches`` asserts
    on the card for this form, and nothing unpacks or densifies a weight
    (the reference does neither on these paths) -> the recorded calls."""
    from repro_torch.core import gemm as gemm_mod
    cs = chip_smoke()
    calls = record_calls(monkeypatch)

    def refuse(*args, **kw):
        raise AssertionError("a weight was unpacked or densified")

    monkeypatch.setattr(gemm_mod, "unpack_operand", refuse)
    monkeypatch.setattr(gemm_mod, "densify_operand", refuse)
    cfg = tm.cfg
    batch = {"tokens": torch.randint(2, cfg.vocab, (2, 8))}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(2, cfg.n_image_tokens,
                                            cfg.d_model)
    want_prefill, want_decode = cs._want_wave_launches(
        cfg, pack=fmt == "k2", sparse=fmt == "k3")
    _, caches = tm.prefill(tp, batch, max_len=16)
    assert tally(calls, fmt) == want_prefill
    prefill = list(calls)
    del calls[:]
    tm.decode_step(tp, torch.tensor([[3], [4]]), caches, 8)
    assert tally(calls, fmt) == want_decode
    return prefill + list(calls)
