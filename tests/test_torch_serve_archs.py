"""The six architectures the port gained last against the JAX package, on
the CPU, at their smoke sizes: starcoder2-3b (layer norm, GELU MLP with
biases, GQA), phi3-medium-14b (GQA 4:1), mixtral-8x22b (8-expert top-2 MoE
with a window), llama-3.2-vision-11b (a gated cross-attention block every
5th layer over image embeddings), rwkv6-1.6b (RWKV-6, no positions) and
recurrentgemma-2b (RG-LRU blocks and local attention, a unit of 3 with a
remainder of 2, tied embeddings).  ``LM.prefill`` then
``LM.decode_step`` logits, the wave engine's tokens for all six, the
continuous engine's tokens for the three with paged kinds, the
refusals of the continuous engine, that training the new kinds no longer
refuses, and the serve CLI.

``params_from_jax`` carries a JAX parameter tree across.  The reference
draws many leaves as constants (biases and norm shifts 0, norm scales 0 or
1, RWKV's lerp bases 0.5, decay base -6 and group-norm scale 1, RG-LRU's
lambda 2 and conv bias 0, the cross gates 0) and its engine serves zero
image embeddings; the tests add seeded numpy noise to every such leaf and
draw the image embeddings non-zero, so a swapped stream, a dropped scale
or a dropped cross block would show.  The JAX side runs its default CPU
backend (XLA).

Tolerances: fp32 logits atol = rtol = 1e-4; bf16 logits atol = rtol =
3e-2, as in ``test_torch_serve_wave.py`` (every GEMM output and the
residual stream rounded to bf16 in both, the reference's XLA attention
rounds the softmax weights to bf16 before P·V where K4 keeps them in f32).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.mpgemm import mpgemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2)}
CONTINUOUS = ["starcoder2-3b", "phi3-medium-14b", "mixtral-8x22b"]
WAVE_ONLY = ["llama-3.2-vision-11b", "rwkv6-1.6b", "recurrentgemma-2b"]
ARCHS = CONTINUOUS + WAVE_ONLY
# Each constant leaf of the reference's init and the noise it gets here.
NOISE = {"b_up": 0.1, "b_down": 0.1, "bias": 0.1, "scale": 0.3,
         "mu": 0.2, "mu_c": 0.2, "w_base": 1.0, "gn_scale": 0.3,
         "lambda_p": 0.5, "conv_b": 0.3, "gate_attn": 1.0, "gate_mlp": 1.0}


def _perturbed(tree, seed):
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


def _pair(arch, policy, seed=0):
    jm = jbuild(jcb.get(arch, smoke=True), policy=policy, remat=False)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed))), seed)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tm = tbuild(tcb.get(arch, smoke=True), policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(tree, tm.cfg))
    return jm, jp, tm, tp


def _image(cfg, b, rng):
    return rng.standard_normal((b, cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, policy):
    """Two left-padded 12-token rows (non-zero image embeddings for the
    VLM), then three decode steps on the same random tokens."""
    jm, jp, tm, tp = _pair(arch, policy)
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    s, max_len = 12, 24
    toks = rng.integers(2, cfg.vocab, (2, s)).astype(np.int32)
    toks[1, :4] = 0
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        img = _image(cfg, 2, rng)
        jb["image_embeds"] = jnp.asarray(img)
        tb["image_embeds"] = torch.from_numpy(img)
    k1, k4 = mpgemm.launches, flash_attention.launches
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=max_len)
    pairs = [(tl, jl)]
    dec = jax.jit(jm.decode_step)
    for i in range(3):
        tok = rng.integers(2, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.int32(s + i))
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc, s + i)
        assert tc2 is tc
        pairs.append((tl, jl))
    assert (mpgemm.launches, flash_attention.launches) == (k1, k4)
    v = cfg.vocab
    for got, want in pairs:
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        assert got.shape == want.shape == (2, tm.vocab_padded)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got[:, :v], want[:, :v], **TOL[policy])


def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    spec = [(7, 6), (12, 4), (5, 6)]            # (prompt length, max new)
    return [cls(uid=i, prompt=rng.integers(2, vocab, (n,)).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("arch", ARCHS)
def test_wave_engine_matches_reference(arch):
    """Three requests in waves of two (zero image embeddings, as both
    engines stub them): the same greedy tokens."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    vocab = jm.cfg.vocab
    want = jeng.generate(_requests(JRequest, vocab))
    got = teng.generate(_requests(Request, vocab))
    assert got == want and sorted(got) == [0, 1, 2]
    assert [s.phase for s in teng.step_telemetry] == \
        [s.phase for s in jeng.step_telemetry]
    assert teng._token_bytes == jeng._token_bytes


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_continuous_engine_matches_reference(arch):
    """Three requests through two slots with chunked prefill: the same
    greedy tokens and phases."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    out = []
    for eng, cls in ((JEngine(jm, jp, max_len=32, max_batch=2, page_size=8),
                      JRequest),
                     (ServeEngine(tm, tp, max_len=32, max_batch=2,
                                  page_size=8), Request)):
        out.append((eng.generate(_requests(cls, jm.cfg.vocab)),
                    [s.phase for s in eng.step_telemetry]))
    assert out[0] == out[1] and sorted(out[1][0]) == [0, 1, 2]


@pytest.mark.parametrize("arch", WAVE_ONLY)
def test_wave_only_kinds_refuse_the_continuous_engine(arch):
    """As in the reference: the recurrent and cross caches are not paged,
    so the continuous engine and the paged caches raise."""
    tm = tbuild(tcb.get(arch, smoke=True), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    assert "wave engine" in tm.paged_unsupported_reason()
    with pytest.raises(ValueError, match="batch_size= for the wave engine"):
        ServeEngine(tm, tp, max_len=32, max_batch=2)
    with pytest.raises(ValueError, match="no paged-KV step"):
        tm.init_paged_caches(4, 8)
    jm = jbuild(jcb.get(arch, smoke=True))
    assert jm.paged_unsupported_reason() == tm.paged_unsupported_reason()


@pytest.mark.parametrize("arch", WAVE_ONLY)
def test_new_kinds_refuse_what_is_not_ported(arch):
    """Nothing is left unported for the cross and recurrent kinds, so
    nothing refuses: under the int8 policy each kind's ``init_train``
    draws f32 masters and ``loss_fn`` (a VLM's batch with image
    embeddings) gives a finite loss and finite, non-zero gradients for
    every leaf that reaches it.  Their gradients are held to the
    reference's in ``test_torch_train_kinds.py`` and
    ``test_torch_train.py``."""
    cfg = tcb.get(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    tm = tbuild(cfg, policy="int8", device="cpu")
    params = tm.init_train(gen)
    leaves = tree_leaves(params)
    assert all(p.dtype == torch.float32 for p in leaves)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 9), generator=gen)}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(2, cfg.n_image_tokens,
                                            cfg.d_model, generator=gen)
    for p in leaves:
        p.requires_grad_(True)
    loss = tm.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in grads if g is not None)
    assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0


def test_every_reference_arch_builds():
    """``get`` resolves all ten of the reference's ``ARCH_IDS``, full size
    and smoke, and each smoke model builds and draws on the CPU."""
    assert tcb.ARCH_IDS == jcb.ARCH_IDS
    for arch in tcb.ARCH_IDS:
        assert tcb.get(arch).name == jcb.get(arch).name
        tm = tbuild(tcb.get(arch, smoke=True), device="cpu")
        params = tm.init(torch.Generator().manual_seed(0))
        assert len(params["layers"]) == len(tm.cfg.pattern)


@pytest.mark.parametrize("arch,engine", [("rwkv6-1.6b", "wave"),
                                         ("starcoder2-3b", "continuous")])
def test_serve_cli_runs_a_new_arch(arch, engine, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", engine, "--requests", "2", "--max-new",
                      "3", "--max-len", "48"])
    assert rc == 0
    out = capsys.readouterr().out
    assert f"engine={engine}" in out and "req1:" in out


def test_serve_cli_refuses_the_continuous_engine_for_a_wave_only_arch():
    with pytest.raises(ValueError, match="wave engine"):
        tserve.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                     "cpu", "--requests", "1", "--max-new", "2"])


# ------------------- the launch counts chip_smoke.py asserts ----------------

def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(monkeypatch):
    """Record every K1 and K4 wrapper call of the model: (kernel, G, K, N,
    epilogue kind, activation, bias, trans_b, f32 FMA) for K1 and the
    ``k1_design`` each would take on the card."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.kernels.mpgemm import k1_design
    from repro_torch.models import attention as attn_mod
    calls = []

    def gemm(name, inner):
        def call(a, b, *, spec, **kw):
            f32 = kw.get("f32_fma", False)
            g = a.shape[0] if a.dim() == 3 else 1
            k = a.shape[-1]
            n = b.shape[-2] if spec.trans_b else b.shape[-1]
            ep = kw["epilogue"]
            calls.append((name, g, k, n, ep.kind, ep.activation,
                          kw.get("bias") is not None, spec.trans_b, f32,
                          k1_design(a, b, f32)))
            return inner(a, b, spec=spec, **kw)
        return call

    monkeypatch.setattr(gemm_mod, "mpgemm", gemm("k1", gemm_mod.mpgemm))
    monkeypatch.setattr(gemm_mod, "mpgemm_grouped",
                        gemm("k1g", gemm_mod.mpgemm_grouped))
    attention = attn_mod.flash_attention

    def flash(q, k, v, **kw):
        calls.append(("k4",))
        return attention(q, k, v, **kw)

    monkeypatch.setattr(attn_mod, "flash_attention", flash)
    return calls


def _tally(calls):
    out = {}
    for name in ("k1", "k1g"):
        mine = [c for c in calls if c[0] == name]
        out[name] = len(mine)
        out[f"{name}_fma"] = sum(c[-1] == "fma" for c in mine)
    out["k4"] = sum(c[0] == "k4" for c in calls)
    return out


@pytest.mark.parametrize("arch", ARCHS + ["whisper-medium",
                                          "phi3-mini-3.8b"])
def test_chip_smoke_wave_counts_match_the_path(arch, monkeypatch):
    """One wave prefill and one decode step of the bf16 smoke model on the
    CPU: the K1, K1 fma-design, grouped K1 and K4 wrapper calls number what
    ``chip_smoke.py``'s ``_want_wave_launches`` asserts on the card, every
    grouped call of the recurrent kinds takes the fma design and every
    other bf16 one wgmma; a decode step's K1 calls are the shapes
    ``_decode_gemms`` times at M = 2."""
    cs = _chip_smoke()
    calls = _recording(monkeypatch)
    tm = tbuild(tcb.get(arch, smoke=True), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    cfg = tm.cfg
    batch = {"tokens": torch.randint(2, cfg.vocab, (2, 8))}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(2, cfg.n_image_tokens,
                                            cfg.d_model)
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(2, cfg.encoder_seq, cfg.d_model)
    want_prefill, want_decode = cs._want_wave_launches(cfg)
    _, caches = tm.prefill(tp, batch, max_len=16)
    assert _tally(calls) == want_prefill
    del calls[:]
    tm.decode_step(tp, torch.tensor([[3], [4]]), caches, 8)
    assert _tally(calls) == want_decode
    for c in calls:
        if c[0] != "k4":
            assert c[-1] == ("fma" if c[-2] else "wgmma"), c
    if arch in ARCHS:
        got = {}
        for c in calls:
            if c[0] != "k4":
                got[c[1:9]] = got.get(c[1:9], 0) + 1
        assert got == cs._decode_gemms(cfg, cfg.n_layers)


@pytest.mark.parametrize("arch", CONTINUOUS)
def test_chip_smoke_serve_counts_match_the_path(arch, monkeypatch):
    """One paged decode step of the bf16 smoke model: its K1 and grouped
    K1 calls number ``_want_launches``' per-step counts (the routers on the
    fma design) and are the shapes of ``_decode_gemms``."""
    cs = _chip_smoke()
    calls = _recording(monkeypatch)
    tm = tbuild(tcb.get(arch, smoke=True), device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    caches = tm.init_paged_caches(5, 8)
    i32 = dict(dtype=torch.int32)
    tm.paged_step(tp, torch.tensor([[3], [4]]), caches,
                  torch.tensor([[1, 2], [3, 4]], **i32),
                  torch.tensor([5, 2], **i32), torch.tensor([1, 1], **i32))
    _, per_step = cs._want_launches(tm.cfg, False, 1)
    tally = _tally(calls)
    assert (tally["k1"], tally["k1g"]) == (per_step["k1"], per_step["k1g"])
    assert tally["k1_fma"] == (tm.cfg.n_layers if tm.cfg.family == "moe"
                               else 0)
    got = {}
    for c in calls:
        got[c[1:9]] = got.get(c[1:9], 0) + 1
    assert got == cs._decode_gemms(tm.cfg, tm.cfg.n_layers)
