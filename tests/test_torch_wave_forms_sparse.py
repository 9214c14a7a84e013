"""The cross and recurrent architectures tile-sparse (``--sparsity``), on
the port's wave path against the JAX package's, on the CPU, at their
smoke sizes (llama-3.2-vision-11b, rwkv6-1.6b, recurrentgemma-2b; the
helpers and the perturbed parameter tree are ``torch_wave_forms.py``'s).

The reference sparsifies its tree (``repro.sparse.sparsify_params`` at
50 %, magnitude or N:M 2:4, on 32 x 32 tiles: every leaf of
``QUANT_LEAVES``; the layers of each position of a stacked unit -- of 5
for llama-vision, of 3 for recurrentgemma -- share one pattern, its
unstacked tail and an untied head stand alone) and ``params_from_jax``
carries the payloads across byte for byte, a stacked leaf sliced per
layer with its shared layout kept.  The RG-LRU gates stay on the fp32
policy against a sparse weight: a bf16 payload is cast to f32 at each
call, an int8 one is read against f32 activations -- K3's f32-A route, as
in the reference; nothing is densified.

The bf16 forms are held against the reference's default backend (XLA,
which densifies each operand: zeros at the pruned tiles, the same
products in another order); the int8 policy's against its ``interpret``
backend (its tile-sparse Pallas body) op by op (see
``torch_wave_forms.py``).

Tolerances: logits atol = rtol = 3e-2 (``TOL``, as
``test_torch_serve_sparse.py`` holds bf16 and int8); decode steps against
a longer prefill the same.  Sparse leaves are compared byte for byte.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_wave_forms as W  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.gemm import mp_dot as jmp_dot  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro.sparse import sparse_param_density as jdensity  # noqa: E402
from repro.sparse import sparsify_magnitude as jsparsify_magnitude  # noqa: E402,E501
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core import gemm as gemm_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _sparse_from_jax, build_model as tbuild, params_from_jax,
)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.sparse import (  # noqa: E402
    TileSparseOperand, sparse_param_bytes, sparse_param_density,
    sparsify_params,
)

# Each method on a kind with a stacked unit; recurrentgemma (its gates on
# K3's f32-A route) both.
CASES = [("llama-3.2-vision-11b", "magnitude"), ("rwkv6-1.6b", "nm"),
         ("recurrentgemma-2b", "magnitude"), ("recurrentgemma-2b", "nm")]


@pytest.mark.parametrize("arch,method", CASES)
def test_sparse_bf16_prefill_and_decode_match_reference(arch, method):
    """Two 8-token rows, then two decode steps, under bf16: logits against
    the reference's, and the last decode step against one longer prefill
    of the same tokens."""
    jm, jp, tm, tp, _ = W.pair(arch, "bf16", ("sparse", method))
    sparse = W.operands(tp, TileSparseOperand)
    assert len(sparse) == W.chip_smoke()._wave_weights(tm.cfg)
    assert {p.layout.dtype for p in sparse} == {"bfloat16"}
    pairs, _, _, toks, img = W.run_both(jm, jp, tm, tp)
    W.assert_pairs_close(pairs)
    np.testing.assert_allclose(pairs[-1][0],
                               W.longer_prefill(tm, tp, toks, img), **W.TOL)


def test_sparse_int8_policy_layer_matches_interpret_kernel():
    """rwkv6's first layer under the int8 policy, N:M int8 tiles (``lora_a``
    and ``w_lora_a`` dense, quantized per call; the carried stacked
    payload sliced), over a prompt from a fresh state and one decode step
    against its cache: outputs and caches against the reference's
    interpret backend, op by op.  (A whole model op by op on that backend
    takes a minute here: the layer carries the same products.)"""
    from repro.models import recurrent as JR
    from repro_torch.models import recurrent as TR
    jm, jp, tm, tp, _ = W.pair("rwkv6-1.6b", "int8", ("sparse", "nm"))
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["stack"][0])
    tl = tp["layers"][0]
    assert {p.layout.dtype for p in W.operands(tl)} == {"int8"}
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.standard_normal((2, 7, tm.cfg.d_model)),
                    jnp.bfloat16)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    jctx = {"cfg": jm.cfg, "policy": "int8", "collect_cache": True,
            "cache_dtype": jnp.bfloat16}
    tctx = {"cfg": tm.cfg, "policy": "int8", "fused": True,
            "collect_cache": True, "cache_dtype": torch.bfloat16}
    with jcfg.gemm_backend("interpret"), jax.disable_jit():
        jy, _, jc = JR.rwkv_fwd(jl, x[:, :6], jctx)
        jd, jc = JR.rwkv_decode(jl, x[:, 6:], jc, jctx)
    ty, _, tc = TR.rwkv_fwd(tl, xt[:, :6], tctx)
    td = TR.rwkv_decode(tl, xt[:, 6:], tc, tctx)
    for got, want in [(ty, jy), (td, jd)] + [(tc[k], jc[k]) for k in jc]:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **W.TOL)


@pytest.mark.parametrize("policy,method", [("bf16", "magnitude"),
                                           ("int8", "nm")])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_own_sparsify_params_is_byte_identical(arch, policy, method):
    """The port sparsifies the f32 tree itself, on the reference's blocks:
    the reference's leaves, sharing groups (units of 5 and 3, the tail)
    and payloads on each kind, byte for byte, and its density."""
    jm, jp, tm, tp, tree = W.pair(arch, policy, ("sparse", method))
    own = tm.load_params(sparsify_params(
        params_from_jax(tree, tm.cfg), cfg=tm.cfg, density=0.5,
        method=method, nm=(2, 4), policy=policy, blocks=W.SPARSE_BLOCKS))
    mine, theirs = list(W.leaves(own)), list(W.leaves(tp))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert isinstance(a, TileSparseOperand) == isinstance(
            b, TileSparseOperand)
        if not isinstance(a, TileSparseOperand):
            assert a.dtype == b.dtype and torch.equal(a, b)
            continue
        assert a.layout == b.layout
        assert torch.equal(a.payload.view(torch.uint8)
                           if a.payload.dtype == torch.bfloat16
                           else a.payload, b.payload.view(torch.uint8)
                           if b.payload.dtype == torch.bfloat16
                           else b.payload)
        assert (a.scales is None) == (b.scales is None)
        if a.scales is not None:
            assert torch.equal(a.scales, b.scales)
    assert sparse_param_bytes(own) == sparse_param_bytes(tp)
    assert sparse_param_density(own, tm.cfg) == pytest.approx(
        jdensity(jp), rel=1e-12)


@pytest.mark.parametrize("policy,method", [("bf16", "magnitude"),
                                           ("int8", "nm")])
@pytest.mark.parametrize("arch", W.ARCHS)
def test_sparse_launches_are_what_chip_smoke_counts(arch, policy, method,
                                                    monkeypatch):
    """A prefill and a decode step of the sparse smoke model (32 x 32
    tiles) number the wrapper calls ``chip_smoke._want_wave_launches``
    asserts on the card, with no weight densified; the sparse kernel takes
    every projection and the gates (f32 A), K1 ``lora_a``, ``w_lora_a``
    and the tied head."""
    tm = tbuild(tcb.get(arch, smoke=True), policy=policy, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0), sparsity=0.5,
                 sparsity_method=method, sparsity_blocks=W.SPARSE_BLOCKS)
    calls = W.check_counts(monkeypatch, tm, tp, "k3")
    a_dtype = torch.int8 if policy == "int8" else torch.bfloat16
    for c in calls:
        if c == "k4" or c.grouped:
            continue
        if c.a_dtype == torch.float32:
            assert c.kernel == "k3" and tm.cfg.name.startswith(
                "recurrentgemma"), c
        else:
            assert c.a_dtype == a_dtype and not c.f32_fma, c


def test_float_payload_under_int8_densifies_only_where_the_reference_does(
        monkeypatch):
    """The one place the sparse path densifies: a float payload under the
    int8 policy (its per-tensor weight quantization needs the dense
    weight), as the reference's ``core/gemm.py`` does; under the fp32
    policy (the RG-LRU gates) the same payload is cast to f32 and its
    stored tiles read.  Both against the reference's interpret backend."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((128, 128)) / 11.0).astype(np.float32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    jp = jsparsify_magnitude(jnp.asarray(w), (32, 32), density=0.5,
                             dtype=jnp.bfloat16)
    tp = _sparse_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    densified = []
    inner = gemm_mod.densify_operand

    def densify(p, **kw):
        densified.append(p.layout.dtype)
        return inner(p, **kw)

    monkeypatch.setattr(gemm_mod, "densify_operand", densify)
    for policy in ("int8", "fp32"):
        xj = jnp.asarray(x, jnp.bfloat16 if policy == "int8"
                         else jnp.float32)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
            torch.bfloat16 if policy == "int8" else torch.float32)
        with jcfg.gemm_backend("interpret"), jax.disable_jit():
            want = jmp_dot(xj, jp, policy=policy)
        got = gemm_mod.mp_dot(xt, tp, policy=policy)
        assert densified == ["bfloat16"]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **W.TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_rglru_gates_on_sparse_tiles_match_reference(dtype):
    """The RG-LRU recurrence with both gates tile-sparse (bf16 tiles cast
    to f32 per call, or int8 tiles with their scales) against f32
    activations -- K3's f32-A route -- against the reference's interpret
    backend, op by op."""
    from repro.models import recurrent as JR
    from repro.sparse import sparsify_params as jsparsify
    from repro_torch.models import recurrent as TR
    _, tree = W._reference("recurrentgemma-2b", "bf16", 0)
    layer = jax.tree_util.tree_map(lambda a: a[0], tree["stack"][0])
    policy = "int8" if dtype == "int8" else "bf16"
    jp = jsparsify({"stack": [{k: layer[k][None] for k in
                               ("w_gate_r", "w_gate_i", "lambda_p")}]},
                   density=0.5, policy=policy, blocks=W.SPARSE_BLOCKS)
    jp = {k: (jax.tree_util.tree_map(lambda a: a[0], v)
              if k == "lambda_p" else v) for k, v in jp["stack"][0].items()}
    tp = {k: torch.from_numpy(np.array(v)) if k == "lambda_p"
          else _sparse_from_jax(jax.tree_util.tree_map(np.asarray, v), 0)
          for k, v in jp.items()}
    for k in ("w_gate_r", "w_gate_i"):
        assert tp[k].layout.dtype == dtype
        jp[k] = jax.tree_util.tree_map(lambda a: a[0], jp[k])
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal((2, 5, 128)), jnp.bfloat16)
    h0 = rng.standard_normal((2, 128)).astype(np.float32)
    with jcfg.gemm_backend("interpret"), jax.disable_jit():
        want = JR.rglru_scan(jp, u, jnp.asarray(h0))
    got = TR.rglru_scan(tp, torch.from_numpy(np.array(
        u.astype(jnp.float32))).to(torch.bfloat16), torch.from_numpy(h0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   **W.TOL)


def _requests(cls, vocab):
    """Two prompts of one length, one wave (one prefill shape for the
    reference's jit to compile)."""
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(2, vocab, (8,)).astype(np.int32),
                max_new_tokens=m) for i, m in enumerate((5, 3))]


@pytest.mark.parametrize("arch,method", [("rwkv6-1.6b", "magnitude"),
                                         ("recurrentgemma-2b", "nm")])
def test_wave_engine_tokens_match_reference_sparse(arch, method):
    """Two requests in one wave through both engines, tile-sparse under
    fp32 (whose logits agree to 1e-4, so no greedy choice flips on a
    rounding): the same greedy tokens."""
    jm, jp, tm, tp, _ = W.pair(arch, "fp32", ("sparse", method))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JEngine(jm, jp, batch_size=2, max_len=32)
        teng = ServeEngine(tm, tp, batch_size=2, max_len=32)
    vocab = tm.cfg.vocab
    want = jeng.generate(_requests(JRequest, vocab))
    got = teng.generate(_requests(Request, vocab))
    assert got == want and sorted(got) == [0, 1]


@pytest.mark.parametrize("arch,args", [
    ("llama-3.2-vision-11b", ["--policy", "int8", "--sparsity-method",
                              "nm"]),
    ("rwkv6-1.6b", []),
    ("recurrentgemma-2b", ["--sparsity-method", "nm"]),
])
def test_cli_sparsity_on_the_wave_engine(arch, args, capsys):
    rc = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "wave", "--requests", "2", "--max-new",
                      "3", "--max-len", "48", "--sparsity", "0.5",
                      "--sparsity-blocks", "32", "32", *args])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[serve] tile-sparse static weights:" in out
    assert "tile density 0.50" in out
    assert "engine=wave" in out and "req1:" in out
