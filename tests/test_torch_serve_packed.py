"""The port's packed serving path against the JAX package's, on the CPU.

The reference packs its parameter tree (``repro.packing.pack_params``) and
``params_from_jax`` carries the packed leaves across byte for byte, so both
packages compute the same function: one ``paged_step`` must give the same
logits on the live rows.  Under bf16 the reference runs its default CPU
backend (XLA, which unpacks each payload and casts it to bf16 -- the same
bf16 weights the packed kernel decodes in registers).  Under the int8
policy it runs ``gemm_backend("interpret")``: its XLA backend re-quantizes
an unpacked payload per tensor (``core/gemm.py:233-240``, then
``:257-262``), so parity with the packed kernel holds only on its kernel
path.

Tolerances: logits atol = rtol = 3e-2, as in ``test_torch_serve.py``: both
round every GEMM output and the residual stream to bf16, the reference's
attention oracle rounds the softmax weights to bf16 before P·V where the
port keeps them in f32, and a bf16 ulp at the logits' scale (about 1) is
2**-8.  Idle rows are excluded.  Packed leaves are compared byte for byte.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro.packing import pack_params as jpack_params  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.kernels.mpgemm import mpgemm, mpgemm_packed  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.packing.params import (  # noqa: E402
    default_blocks, pack_params, packed_param_bytes,
)

TOL = dict(atol=3e-2, rtol=3e-2)

# Two unit kinds (stacked) plus an unstacked tail layer: params_from_jax
# slices stacked payloads and carries plain 2-D ones.
MIXED = dict(block_pattern=("dense", "attn_local", "dense"),
             local_attn_window=5, vocab=500, n_layers=3)


def _configs(arch):
    if arch == "mixed":
        j = dataclasses.replace(jcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        t = dataclasses.replace(tcb.get("phi3-mini-3.8b", smoke=True),
                                name="mixed", **MIXED)
        return j, t
    return jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)


def _packed_pair(arch, policy, pack_format, seed=0):
    jcfg_, tcfg = _configs(arch)
    jm = jbuild(jcfg_, policy=policy, remat=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    jpp = jpack_params(jp, policy=policy, pack_format=pack_format)
    tm = tbuild(tcfg, policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jpp), tcfg))
    return jm, jp, jpp, tm, tp


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _step_both(jm, jpp, tm, tp):
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

    jc = jm.init_paged_caches(n_pages, ps)
    step = jax.jit(jm.paged_step)
    _, jc = step(jpp, jnp.asarray(pre), jc, jnp.asarray(bt),
                 jnp.asarray(zeros), jnp.asarray(first))
    want, _ = step(jpp, jnp.asarray(toks), jc, jnp.asarray(bt),
                   jnp.asarray(q_start), jnp.asarray(n_valid))
    want = np.asarray(want.astype(jnp.float32))

    tc = tm.init_paged_caches(n_pages, ps)
    tt = torch.from_numpy
    tm.paged_step(tp, tt(pre), tc, tt(bt), tt(zeros), tt(first))
    got, _ = tm.paged_step(tp, tt(toks), tc, tt(bt), tt(q_start),
                           tt(n_valid))
    return got.float().numpy(), want, n_valid > 0


@pytest.mark.parametrize("pack_format", [None, "int8", "int4", "fp8"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mixed"])
def test_packed_paged_step_matches_reference_bf16(arch, pack_format):
    jm, _, jpp, tm, tp = _packed_pair(arch, "bf16", pack_format)
    gemm_weights = [v for v in _leaves(tp["layers"])
                    if isinstance(v, PackedOperand)]
    assert len(gemm_weights) == 7 * len(tm.cfg.pattern)
    assert isinstance(tp["head"], PackedOperand)
    k1 = mpgemm.launches
    got, want, live = _step_both(jm, jpp, tm, tp)
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.isfinite(got).all()
    assert mpgemm.launches == k1 and mpgemm_packed.launches == 0


@pytest.mark.parametrize("pack_format", [None, "int4", "fp8"])
def test_packed_paged_step_matches_interpret_kernel_int8(pack_format):
    """int8 policy: int8 / int4 payloads against per-tensor-quantized
    activations (sx in the scale slot), fp8 against bf16 activations."""
    jm, _, jpp, tm, tp = _packed_pair("phi3-mini-3.8b", "int8",
                                      pack_format)
    payload = tp["head"].layout.dtype
    assert payload == {None: "int8", "int4": "int4", "fp8": "fp8e4m3"}[
        pack_format]
    with jcfg.gemm_backend("interpret"):
        got, want, live = _step_both(jm, jpp, tm, tp)
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("policy,pack_format", [
    ("bf16", None), ("bf16", "int4"), ("bf16", "fp8"), ("int8", None)])
def test_own_pack_params_with_reference_blocks_is_byte_identical(
        policy, pack_format):
    """The port packs the f32 draw itself: given the reference's blocks,
    every leaf is the reference's, byte for byte."""
    _, jp, jpp, tm, tp = _packed_pair("mixed", policy, pack_format)
    dense = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.cfg)
    blocks = {(p.layout.k, p.layout.n): (p.layout.bk, p.layout.bn)
              for p in _leaves(tp) if isinstance(p, PackedOperand)}
    own = pack_params(dense, policy=policy, pack_format=pack_format,
                      blocks=lambda k, n: blocks[(k, n)])
    theirs = [v for v in _leaves(tp)]
    mine = [v for v in _leaves(tm.load_params(own))]
    assert len(mine) == len(theirs)
    n_packed = 0
    for a, b in zip(mine, theirs):
        assert isinstance(a, PackedOperand) == isinstance(b, PackedOperand)
        if not isinstance(a, PackedOperand):
            continue
        n_packed += 1
        assert a.layout == b.layout
        assert a.payload.dtype == b.payload.dtype
        assert torch.equal(a.payload.view(torch.uint8),
                           b.payload.view(torch.uint8))
        assert (a.scales is None) == (b.scales is None)
        if a.scales is not None:
            assert torch.equal(a.scales, b.scales)
    assert n_packed == 7 * len(tm.cfg.pattern) + 1
    assert packed_param_bytes(own) == packed_param_bytes(tp)


def test_default_blocks_rule():
    assert default_blocks(3072, 8192) == (128, 128)
    assert default_blocks(96, 512) == (96, 128)
    m = tbuild(tcb.get("phi3-mini-3.8b", smoke=True), device="cpu")
    p = m.init(torch.Generator().manual_seed(0), pack=True,
               pack_format="int4")
    wq = p["layers"][0]["attn"]["wq"]
    assert (wq.layout.bk, wq.layout.bn, wq.layout.dtype) == (96, 96, "int4")
    assert p["head"].layout.payload_shape == (1, 4, 48, 128)
    assert p["embed"].dtype == torch.bfloat16


def test_int8_policy_keeps_dense_weights_f32():
    """The reference quantizes an f32 weight per call; a bf16 or int8 copy
    stored at load time would quantize other values."""
    m = tbuild(tcb.get("phi3-mini-3.8b", smoke=True), policy="int8",
               device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    assert p["layers"][0]["mlp"]["w_up"].dtype == torch.float32
    assert p["head"].dtype == torch.float32
    assert p["embed"].dtype == torch.bfloat16


def _cli(capsys, *args):
    rc = tserve.main(["--smoke", "--device", "cpu", "--requests", "2",
                      "--max-new", "4", *args])
    out = capsys.readouterr().out
    assert rc == 0
    return out


def _tokens(out):
    return [ln for ln in out.splitlines() if ln.startswith("  req")]


def test_cli_pack_int4_on_cpu(capsys):
    out = _cli(capsys, "--pack", "--pack-format", "int4")
    assert "MiB payload, format=int4" in out
    assert "on cpu: 2 requests, 8 tokens" in out
    assert len(_tokens(out)) == 2


def test_cli_pack_bf16_gives_the_same_tokens_as_no_pack(capsys):
    """A bf16 payload is a change of layout only."""
    plain = _tokens(_cli(capsys))
    packed = _cli(capsys, "--pack")
    assert "MiB payload" in packed
    assert _tokens(packed) == plain


def test_cli_int8_policy_with_and_without_pack(capsys):
    out = _cli(capsys, "--policy", "int8", "--pack")
    assert "policy=int8" in out and len(_tokens(out)) == 2
    out = _cli(capsys, "--policy", "int8")
    assert "policy=int8" in out and len(_tokens(out)) == 2


def test_cli_pack_format_requires_pack():
    with pytest.raises(SystemExit, match="--pack-format requires --pack"):
        tserve.main(["--smoke", "--device", "cpu", "--pack-format", "int4"])
