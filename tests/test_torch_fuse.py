"""The port's fusion toggle (``LM(fused_epilogues=False)``, the serve CLI's
``--no-fuse``) against the JAX package's ``fused_epilogue(False)``.

Unfused, every MLP runs the reference's unfused branch: the same GEMMs
(gate, up and down; up and down for the GELU MLP), with the activation,
the gating product and the residual add as separate ops.  One mixed
``paged_step`` (phi3-mini and granite-moe smoke configs) and a wave
prefill and decode step (whisper smoke, the GELU MLP with biases) are held
against the reference's, fused and unfused, with the weights carried
across by ``params_from_jax``.  The reference runs eagerly, so its toggle
is read on every call.

Tolerances: fp32 logits atol = rtol = 1e-4 (summation order only); bf16
logits atol = rtol = 3e-2, as ``tests/test_torch_serve.py`` (every GEMM
output and the residual stream are rounded to bf16 in both, and the
reference's attention oracle rounds P to bf16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core import gemm as tgemm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)

TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=3e-2, rtol=3e-2)}


def _pair(arch, policy, fused):
    jc, tc = jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)
    jm = jbuild(jc, policy=policy, remat=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(tc, policy=policy, device="cpu", fused_epilogues=fused)
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tc))
    return jm, jp, tm, tp


def _gemm_calls(monkeypatch):
    """Count the port's 2-D and grouped GEMM calls (each one launch on the
    card)."""
    calls = []
    for name in ("mpgemm", "mpgemm_grouped"):
        real = getattr(tgemm, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(tgemm, name, spy)
    return calls


def _paged_both(jm, jp, tm, tp, fused):
    """A context chunk, then a mixed step (a full row, a row with dead
    columns, an idle row); -> (port logits, reference logits, live)."""
    ps, n_pages, b, c, w = 8, 12, 3, 8, 5
    rng = np.random.default_rng(0)
    bt = np.zeros((b, w), np.int32)
    bt[0, :3] = [3, 5, 7]
    bt[1, :2] = [2, 9]
    q_start = np.array([c, 0, 0], np.int32)
    n_valid = np.array([c, 5, 0], np.int32)
    toks = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    pre = rng.integers(2, jm.cfg.vocab, (b, c)).astype(np.int32)
    zeros, first = np.zeros(b, np.int32), np.array([c, 0, 0], np.int32)
    with jcfg.fused_epilogue(fused):
        jc = jm.init_paged_caches(n_pages, ps)
        _, jc = jm.paged_step(jp, jnp.asarray(pre), jc, jnp.asarray(bt),
                              jnp.asarray(zeros), jnp.asarray(first))
        want, _ = jm.paged_step(jp, jnp.asarray(toks), jc, jnp.asarray(bt),
                                jnp.asarray(q_start), jnp.asarray(n_valid))
    tc = tm.init_paged_caches(n_pages, ps)
    tt = torch.from_numpy
    tm.paged_step(tp, tt(pre), tc, tt(bt), tt(zeros), tt(first))
    got, _ = tm.paged_step(tp, tt(toks), tc, tt(bt), tt(q_start),
                           tt(n_valid))
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            n_valid > 0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_paged_step_matches_reference(arch, policy, fused):
    jm, jp, tm, tp = _pair(arch, policy, fused)
    got, want, live = _paged_both(jm, jp, tm, tp, fused)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[live], want[live], **TOL[policy])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_unfused_step_runs_the_same_gemms(arch, monkeypatch):
    """The unfused MLP has the same three GEMMs as the fused one, so a step
    issues the same 2-D and grouped GEMM calls; only the elementwise work
    moves out of the epilogue.  fp32: the two steps agree to summation
    order."""
    calls = _gemm_calls(monkeypatch)
    out = {}
    for fused in (True, False):
        jm, jp, tm, tp = _pair(arch, "fp32", fused)
        del calls[:]
        got, _, live = _paged_both(jm, jp, tm, tp, fused)
        out[fused] = (got[live], sorted(calls))
    assert out[True][1] == out[False][1]
    np.testing.assert_allclose(out[False][0], out[True][0], **TOL["fp32"])


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_whisper_wave_steps_match_reference(fused):
    """whisper's GELU MLP (with biases) unfused and fused: one prefill and
    one decode step of two rows."""
    arch = "whisper-medium"
    jm, jp, tm, tp = _pair(arch, "fp32", fused)
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    s, max_len = 10, 16
    toks = rng.integers(2, cfg.vocab, (2, s)).astype(np.int32)
    audio = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tok = rng.integers(2, cfg.vocab, (2, 1)).astype(np.int32)
    with jcfg.fused_epilogue(fused):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "audio_embeds": jnp.asarray(audio)},
                            max_len=max_len)
        jd, _ = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(s))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "audio_embeds": torch.from_numpy(audio)},
                        max_len=max_len)
    td, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, s)
    v = cfg.vocab
    for got, want in ((tl, jl), (td, jd)):
        np.testing.assert_allclose(got.float().numpy()[:, :v],
                                   np.asarray(want, np.float32)[:, :v],
                                   **TOL["fp32"])


def test_cli_no_fuse_gives_the_fused_tokens(capsys):
    """``--no-fuse`` on the CPU: the smoke config's greedy tokens equal the
    fused run's (bf16)."""
    lines = {}
    for flag in ([], ["--no-fuse"]):
        assert tserve.main(["--smoke", "--device", "cpu", "--requests", "2",
                            "--max-new", "4", *flag]) == 0
        lines[bool(flag)] = [ln for ln in capsys.readouterr().out.splitlines()
                             if ln.strip().startswith("req")]
    assert lines[True] == lines[False] and len(lines[True]) == 2
