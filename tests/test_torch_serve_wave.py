"""The port's wave serving path against the JAX package's, on the CPU:
``LM.prefill`` / ``LM.decode_step`` (whisper's encoder-decoder, phi3,
danube3 with a window shorter than the sequence, granite's MoE), the wave
engine (``ServeEngine(batch_size=)``), the layers whisper adds (layer norm,
the GELU MLP with biases) and the CLI's ``--engine wave``.

``params_from_jax`` carries a JAX parameter tree across, so both packages
compute the same function.  The reference draws its biases and layer-norm
affine terms as zeros and ones; the tests add seeded numpy noise to them
in the tree both packages load, so a dropped bias would show.  The JAX
side runs its default CPU backend (XLA: dense, banded or chunked attention
by shape), and its interpret backend for the int8 policy's packed weights
(see ``test_torch_serve_packed.py``).

Tolerances: fp32 logits atol = rtol = 1e-4 (summation order only).  bf16
logits atol = rtol = 3e-2, as in ``test_torch_serve.py``: every GEMM output
and the residual stream are rounded to bf16 in both, the reference's XLA
attention rounds the softmax weights to bf16 before P·V where K4 keeps them
in f32, and a bf16 ulp at the logits' scale (about 1) is 2**-8.  Layer
norm and the GELU MLP: f32 1e-5 and 1e-4; bf16 one bf16 rounding of the
output (rtol 2**-7).

granite under bf16 is compared with the reference's rounding of P: its
top-k routing is ill-conditioned on this input (the 4th and 5th gates of
a token are 7e-4 apart), and keeping P in f32 moves the last token of the
left-padded row to another expert set in layer 1, which moves its logits
by up to 0.044.  With P rounded as the reference rounds it, the routing
agrees and the logits agree within the bf16 bound; K4's f32 P is checked
on every other architecture and in ``test_torch_flash_attention.py``.
"""
import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.packing import pack_params as jpack_params  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    NEG_INF, _attention_mask, flash_attention,
)
from repro_torch.kernels.mpgemm import mpgemm, mpgemm_packed  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2),
       "int8": dict(atol=3e-2, rtol=3e-2)}
WHISPER = "whisper-medium"


def _configs(arch):
    if arch == "danube-window":
        # A window shorter than the 12-token prompts: the reference runs
        # banded attention at prefill, and the decode ring wraps.
        j = dataclasses.replace(jcb.get("h2o-danube3-4b", smoke=True),
                                window=5)
        t = dataclasses.replace(tcb.get("h2o-danube3-4b", smoke=True),
                                window=5)
        return j, t
    return jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)


def _perturbed(tree, seed):
    """The tree with seeded noise on every bias and norm affine term."""
    rng = np.random.default_rng(seed)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if name in ("b_up", "b_down", "bias", "scale"):
            noise = 0.1 * rng.standard_normal(node.shape)
            return (node + noise).astype(node.dtype)
        return node

    return walk(tree)


def _pair(arch, policy, seed=0, pack_format=None, pack=False):
    jcfg_, tcfg = _configs(arch)
    jm = jbuild(jcfg_, policy=policy, remat=False)
    tree = _perturbed(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed))), seed)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if pack:
        jp = jpack_params(jp, policy=policy, pack_format=pack_format)
    tm = tbuild(tcfg, policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tm.cfg))
    return jm, jp, tm, tp


def _prefill_decode(jm, jp, tm, tp, *, s=12, max_len=24, steps=3, seed=0):
    """Prefill of two left-padded rows, then ``steps`` decode steps on the
    same random tokens in both; -> [(port logits, reference logits)]."""
    cfg = jm.cfg
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (2, s)).astype(np.int32)
    toks[1, :4] = 0                                   # left padding
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "audio":
        audio = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
        jb["audio_embeds"] = jnp.asarray(audio, jnp.float32)
        tb["audio_embeds"] = torch.from_numpy(audio.astype(np.float32))
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(jp, jb)
    tl, tc = tm.prefill(tp, tb, max_len=max_len)
    out = [(tl, jl)]
    dec = jax.jit(jm.decode_step)
    for i in range(steps):
        tok = rng.integers(2, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = dec(jp, jnp.asarray(tok), jc, jnp.int32(s + i))
        tl, tc2 = tm.decode_step(tp, torch.from_numpy(tok), tc, s + i)
        assert tc2 is tc                              # updated in place
        out.append((tl, jl))
    return [(t.float().numpy(), np.asarray(j.astype(jnp.float32)))
            for t, j in out]


def _check_logits(tm, pairs, tol):
    for got, want in pairs:
        assert got.shape == want.shape == (2, tm.vocab_padded)
        assert np.isfinite(got).all()
        v = tm.cfg.vocab
        np.testing.assert_allclose(got[:, :v], want[:, :v], **tol)
        if tm.vocab_padded != v:                      # masked padding
            assert (got[:, v:] < -9e29).all() and (want[:, v:] < -9e29).all()


ARCHS = [WHISPER, "phi3-mini-3.8b", "danube-window", "granite-moe-1b-a400m"]


def _attention_rounding_p(q, k, v, *, causal=True, window=None, scale=None):
    """The reference's XLA attention: K4's math with P rounded to V's
    dtype before P·V."""
    b, h, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    qg = q.reshape(b, hkv, h // hkv, tq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / d ** 0.5
    s = torch.where(_attention_mask(tq, tk, causal, window, q.device), s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, h, tq, d).to(q.dtype)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch, policy,
                                                    monkeypatch):
    if arch == "granite-moe-1b-a400m" and policy == "bf16":
        monkeypatch.setattr(tattn, "attention_core", _attention_rounding_p)
    jm, jp, tm, tp = _pair(arch, policy)
    k1, k4 = mpgemm.launches, flash_attention.launches
    _check_logits(tm, _prefill_decode(jm, jp, tm, tp), TOL[policy])
    assert (mpgemm.launches, flash_attention.launches) == (k1, k4)


@pytest.mark.parametrize("policy,pack_format", [("bf16", "int4"),
                                                ("int8", None)])
def test_packed_whisper_prefill_and_decode_match_reference(policy,
                                                           pack_format):
    """Packed weights on the wave path: int4 payloads under bf16 (the
    reference's XLA backend), int8 payloads under the int8 policy (its
    interpret backend, whose attention is the Pallas K4 in interpret
    mode)."""
    jm, jp, tm, tp = _pair(WHISPER, policy, pack=True,
                           pack_format=pack_format)
    packed = [p for p in jax.tree_util.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, PackedOperand))
        if isinstance(p, PackedOperand)]
    # 10 per decoder layer, 6 per encoder layer, the head.
    assert len(packed) == 10 * 2 + 6 * 2 + 1
    k2 = mpgemm_packed.launches
    if policy == "int8":
        with jcfg.gemm_backend("interpret"):
            pairs = _prefill_decode(jm, jp, tm, tp, steps=1)
    else:
        pairs = _prefill_decode(jm, jp, tm, tp, steps=2)
    _check_logits(tm, pairs, TOL[policy])
    assert mpgemm_packed.launches == k2


def test_params_from_jax_carries_the_encoder_and_positions():
    jm, jp, tm, tp = _pair(WHISPER, "fp32")
    cfg = tm.cfg
    assert cfg.pattern == ("encdec",) * cfg.n_layers
    assert len(tp["encoder"]) == cfg.encoder_layers == 2
    for i, layer in enumerate(tp["encoder"]):
        for path in (("attn", "wq"), ("mlp", "b_up"), ("ln2", "bias")):
            want = np.asarray(jp["encoder"][path[0]][path[1]])[i]
            assert np.array_equal(layer[path[0]][path[1]].numpy(), want)
    assert np.array_equal(tp["pos_embed"].numpy(), np.asarray(jp["pos_embed"]))
    assert tp["pos_embed"].shape == (32768 + 8, cfg.d_model)
    assert np.array_equal(tp["enc_pos"].numpy(), np.asarray(jp["enc_pos"]))
    assert np.array_equal(tp["enc_norm"]["bias"].numpy(),
                          np.asarray(jp["enc_norm"]["bias"]))
    for u in range(cfg.n_layers):
        layer = tp["layers"][u]
        assert set(layer) == {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}
        assert np.array_equal(layer["xattn"]["wk"].numpy(),
                              np.asarray(jp["stack"][0]["xattn"]["wk"])[u])
        assert np.array_equal(layer["lnx"]["scale"].numpy(),
                              np.asarray(jp["stack"][0]["lnx"]["scale"])[u])


# ============================== engine e2e ===================================

def _requests(cls, vocab):
    rng = np.random.default_rng(3)
    spec = [(7, 6), (12, 4), (5, 6)]            # (prompt length, max new)
    return [cls(uid=i, prompt=rng.integers(2, vocab, (n,)).astype(np.int32),
                max_new_tokens=m) for i, (n, m) in enumerate(spec)]


@pytest.mark.parametrize("arch", [WHISPER, "phi3-mini-3.8b",
                                  "granite-moe-1b-a400m"])
def test_wave_engine_matches_reference(arch):
    """Three requests in waves of two: the same greedy tokens, the same
    per-phase records, the same WaveTelemetry apart from wall times."""
    jm, jp, tm, tp = _pair(arch, "fp32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
    with pytest.warns(DeprecationWarning, match="wave engine"):
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    vocab = jm.cfg.vocab
    want = jeng.generate(_requests(JRequest, vocab))
    got = teng.generate(_requests(Request, vocab))
    assert got == want and sorted(got) == [0, 1, 2]
    assert [len(v) for v in got.values()] <= [6, 4, 6]

    def timeless(records):
        return [dataclasses.replace(r, wall_s=0.0, prefill_s=0.0,
                                    tokens_per_s=0.0) for r in records]

    assert len(teng.telemetry) == 2
    assert [dataclasses.asdict(r) for r in timeless(teng.telemetry)] == \
        [dataclasses.asdict(r) for r in timeless(jeng.telemetry)]
    keys = ("step", "phase", "live", "queue_depth", "tokens")
    assert [tuple(getattr(s, k) for k in keys)
            for s in teng.step_telemetry] == \
        [tuple(getattr(s, k) for k in keys) for s in jeng.step_telemetry]


def test_whisper_refuses_the_continuous_engine():
    _, _, tm, tp = _pair(WHISPER, "fp32")
    assert "wave engine" in tm.paged_unsupported_reason()
    with pytest.raises(ValueError, match="batch_size= for the wave engine"):
        ServeEngine(tm, tp, max_len=32, max_batch=2)
    with pytest.raises(ValueError, match="no paged-KV step"):
        tm.init_paged_caches(4, 8)
    eng = ServeEngine.__new__(ServeEngine)
    eng._wave_mode = True
    with pytest.raises(RuntimeError, match="continuous engine"):
        eng.step()


def test_unported_block_kinds_raise():
    """Every kind of the reference is ported; a kind neither package has
    still raises, and so does an unknown position embedding."""
    cfg = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True),
                              block_pattern=("dense", "mamba"))
    with pytest.raises(ValueError, match="mamba"):
        tbuild(cfg, device="cpu")
    cfg = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True),
                              pos_embed="alibi")
    with pytest.raises(ValueError, match="alibi"):
        tbuild(cfg, device="cpu")


def test_init_caches_shapes():
    tm = tbuild(tcb.get(WHISPER, smoke=True), device="cpu")
    caches = tm.init_caches(3, 20)
    cfg = tm.cfg
    assert len(caches) == cfg.n_layers
    assert caches[0]["self"]["k"].shape == (3, cfg.n_kv_heads, 20,
                                            cfg.head_dim)
    assert caches[0]["cross"]["v"].shape == (3, cfg.n_kv_heads,
                                             cfg.encoder_seq, cfg.head_dim)
    tm = tbuild(_configs("danube-window")[1], device="cpu")
    assert tm.init_caches(1, 20)[0]["k"].shape[2] == 5


# ================================ layers =====================================

def _both(a, dtype):
    if dtype == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((4, 7, 48))).astype(np.float32)
    w, b = (rng.standard_normal(48).astype(np.float32) for _ in range(2))
    xj, xt = _both(x, dtype)
    want = jlayers.layernorm(xj, jnp.asarray(w), jnp.asarray(b))
    got = tlayers.layernorm(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == xt.dtype
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else \
        dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_gelu_mlp_matches_reference(policy):
    """Bias + tanh GELU fused into the up projection, bias + residual into
    the down projection."""
    rng = np.random.default_rng(2)
    d, f = 32, 80
    params = {"w_up": rng.standard_normal((d, f)) / d ** 0.5,
              "w_down": rng.standard_normal((f, d)) / f ** 0.5,
              "b_up": rng.standard_normal(f), "b_down": rng.standard_normal(d)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    r = rng.standard_normal((3, 5, d)).astype(np.float32)
    dt = "bf16" if policy == "bf16" else "fp32"
    (xj, xt), (rj, rt) = _both(x, dt), _both(r, dt)
    want = jlayers.gelu_mlp({k: jnp.asarray(v) for k, v in params.items()},
                            xj, policy, residual=rj)
    got = tlayers.gelu_mlp({k: torch.from_numpy(v) for k, v in
                            params.items()}, xt, policy, residual=rt)
    tol = dict(atol=1e-4, rtol=1e-4) if policy == "fp32" else \
        dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


# ================================== CLI ======================================

def test_cli_serves_whisper_on_the_wave_engine():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", WHISPER,
         "--smoke", "--engine", "wave", "--device", "cpu", "--requests", "3",
         "--max-new", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=240, env={"PYTHONPATH": str(ROOT / "src"),
                          "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "whisper-smoke on cpu: 3 requests, 12 tokens" in r.stdout
    assert "engine=wave" in r.stdout
    assert r.stdout.count("  wave") == 2 and r.stdout.count("  req") == 3


def _cli(capsys, *args):
    rc = tserve.main(["--smoke", "--device", "cpu", "--requests", "2",
                      "--max-new", "3", *args])
    assert rc == 0
    return capsys.readouterr().out


def test_cli_wave_engine_and_deprecated_batch_alias(capsys):
    out = _cli(capsys, "--engine", "wave", "--batch", "1")
    assert "--batch is deprecated" in out
    assert out.count("  wave") == 2                # two waves of one
    assert "engine=wave" in out


def test_cli_wave_gives_continuous_tokens_for_a_single_request(capsys):
    """One request: no padding, so both engines see the same sequence."""
    tokens = []
    for engine in ("continuous", "wave"):
        out = _cli(capsys, "--engine", engine, "--requests", "1",
                   "--policy", "bf16")
        tokens.append([ln for ln in out.splitlines()
                       if ln.startswith("  req")])
    assert tokens[0] == tokens[1] and len(tokens[0]) == 1


def test_cli_warm_prefix_refuses_the_wave_engine():
    with pytest.raises(SystemExit, match="--engine continuous"):
        tserve.main(["--smoke", "--device", "cpu", "--engine", "wave",
                     "--warm-prefix", "16"])


@pytest.mark.parametrize("engine", ["wave", "continuous"])
def test_cli_prints_the_cuda_graphs_line(engine, capsys):
    """Both engines print one ``CUDA graphs:`` line; a CPU model captures
    nothing."""
    out = _cli(capsys, "--engine", engine)
    lines = [ln for ln in out.splitlines() if "CUDA graphs:" in ln]
    assert lines == ["[serve] CUDA graphs: none captured (a CPU model runs "
                     "the eager step)"]
