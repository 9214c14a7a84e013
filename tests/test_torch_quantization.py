"""The port's static int8 weight storage (``core/quantization.py``) against
the JAX package's, on the CPU.

The reference runs op by op (``jax.disable_jit()``): jitted, XLA turns its
``/ 127.0`` into a multiply by 1/127, which moves a scale by one f32 ulp
now and then (ROADMAP C).  Op by op, ``quantize_tensor`` and
``quantize_params`` give the port's bits exactly: int8 ``q`` equal, the f32
``scale`` equal bit for bit.  ``quantize_params`` shares one scale over
each of the reference's stacked leaves: a ``stack[p]`` unit position's
layers, the encoder's layers, and MoE expert stacks across layers.

``mp_dot`` / ``mp_dot_grouped`` on a ``{"q", "scale"}`` dict: held to the
reference's XLA backend (the one that dequantizes the dict; op by op under
int8) with ``test_torch_gemm.py``'s tolerances (fp32 1e-5; a bf16 output
1.6e-2), and bit-equal to the port's own call on the dequantized dense
weight.  A served smoke step (prefill, one decode) from static int8
parameters is held to the reference's ``prefill`` / ``decode_step`` within
2 % of the largest |logit| (the serve gate of ``chip_smoke.py``), and is
bit-equal to the port's dense twin on dequantized weights.

Two faults of the reference are pinned here (ROADMAP C).  Its
``quantize_params`` skips bf16 leaves (``ml_dtypes.bfloat16`` has numpy
kind ``'V'``, not ``'f'``), so a bf16 tree comes back unchanged; the port
quantizes every float leaf.  And its model cannot serve its own quantized
tree: the stacked leaves' one 0-d ``scale`` has no layer axis for
``lax.scan`` to slice, and ``prefill`` raises ``IndexError``.  The serving
parity test therefore hands the reference its quantized tree with each
stacked scale repeated along the layer axis (the same value for every
layer, so the same function).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import base as jcb  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro.core.gemm import mp_dot as jmp_dot  # noqa: E402
from repro.core.gemm import mp_dot_grouped as jmp_dot_grouped  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402
from repro_torch.core.gemm import mp_dot, mp_dot_grouped  # noqa: E402
from repro_torch.core.policy import quantize_per_tensor  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    build_model as tbuild, params_from_jax,
)

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=1.6e-2, rtol=1.6e-2),
       "int8": dict(atol=1.6e-2, rtol=1.6e-2)}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


SEEDS = {"zero": 5, "subnormal": 6, "bf16": 7}


def _tensor_case(case):
    rng = np.random.default_rng(SEEDS.get(case, case))
    if case == "zero":
        return np.zeros((7, 5), np.float32)
    if case == "subnormal":
        return (rng.standard_normal((9, 33)) * 1e-40).astype(np.float32)
    if case == "bf16":
        return rng.standard_normal((24, 130)).astype(ml_dtypes.bfloat16)
    return (rng.standard_normal((3, 40, 19)) * 10.0 ** (case - 2)).astype(
        np.float32)


@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, "zero", "subnormal",
                                  "bf16"])
def test_quantize_tensor_bit_equal_to_the_reference(case):
    w = _tensor_case(case)
    with jax.disable_jit():
        want = jq.quantize_tensor(jnp.asarray(w))
        want_bf16 = jq.dequantize_tensor(want)
        want_f32 = jq.dequantize_tensor(want, jnp.float32)
    t = (torch.from_numpy(w.view(np.uint16)).view(torch.bfloat16)
         if w.dtype == ml_dtypes.bfloat16 else torch.from_numpy(w))
    got = tq.quantize_tensor(t)
    assert got["q"].dtype == torch.int8 and got["scale"].dim() == 0
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert _bits(got["scale"].numpy()) == _bits(want["scale"])
    q, s = quantize_per_tensor(t)
    assert torch.equal(q, got["q"]) and torch.equal(s, got["scale"])
    bf16 = tq.dequantize_tensor(got)
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.view(torch.int16).numpy(),
                                  np.asarray(want_bf16).view(np.int16))
    np.testing.assert_array_equal(
        _bits(tq.dequantize_tensor(got, torch.float32).numpy()),
        _bits(want_f32))
    assert tq.is_quantized(got) and not tq.is_quantized(t)


@functools.lru_cache(maxsize=None)
def _reference_tree(arch, seed=0):
    """The reference model and a parameter tree of its structure (numpy
    leaves, seeded normal draws: the values need not be its init's)."""
    jm = jbuild(jcb.get(arch, smoke=True), policy="bf16", remat=False)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed))
    return jm, jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)


def _quantized_leaves(tree, path=()):
    if tq.is_quantized(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quantized_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _quantized_leaves(v, path + (i,))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m",
                                  "whisper-medium", "recurrentgemma-2b"])
def test_quantize_params_bit_equal_per_stack_group(arch):
    """The reference's quantized tree, carried across by
    ``params_from_jax``, equals the port's ``quantize_params`` of the same
    dense tree leaf for leaf; the layers of one stack share a scale, each
    tail layer has its own."""
    jm, tree = _reference_tree(arch)
    with jax.disable_jit():
        jquant = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    cfg = tcb.get(arch, smoke=True)
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jquant), cfg)
    got = tq.quantize_params(params_from_jax(tree, cfg), cfg=cfg)
    want = dict(_quantized_leaves(carried))
    have = dict(_quantized_leaves(got))
    assert want and sorted(have) == sorted(want)
    for path, d in have.items():
        assert d["q"].dtype == torch.int8 and d["scale"].dim() == 0, path
        assert torch.equal(d["q"], want[path]["q"]), path
        assert _bits(d["scale"].numpy()) == _bits(want[path]["scale"].numpy())
    groups = tq.layer_groups(len(got["layers"]), cfg)
    scales = {}
    for path, d in have.items():
        key = tq.group_key(path, groups)
        scales.setdefault(key, set()).add(float(d["scale"]))
    assert all(len(s) == 1 for s in scales.values())
    if arch == "recurrentgemma-2b":       # a stacked unit and two tail layers
        assert ("tail", 3) in groups and ("tail", 4) in groups
        assert (have[("layers", 3, "w_x")]["scale"]
                != have[("layers", 4, "w_x")]["scale"])
    if arch == "whisper-medium":
        assert (have[("encoder", 0, "attn", "wq")]["scale"]
                == have[("encoder", 1, "attn", "wq")]["scale"])
    # Embeddings, norms and routers stay as they were.
    assert torch.is_tensor(got["embed"])
    if arch == "granite-moe-1b-a400m":
        assert torch.is_tensor(got["layers"][0]["router"])
        assert tq.is_quantized(got["layers"][0]["w_up"])


def _scannable(tree, stacked=False):
    """The reference's quantized tree with every stacked 0-d ``scale``
    repeated along its stack's layer axis, which ``lax.scan`` slices."""
    if jq.is_quantized(tree):
        if not stacked:
            return tree
        return {"q": tree["q"], "scale": jnp.broadcast_to(
            tree["scale"], tree["q"].shape[:1])}
    if isinstance(tree, dict):
        return {k: _scannable(v, stacked or k in ("stack", "encoder"))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scannable(v, stacked) for v in tree]
    return tree


def _pair_static(arch, policy, seed=0):
    jm, tree = _reference_tree(arch, seed)
    jm = jbuild(jcb.get(arch, smoke=True), policy=policy, remat=False)
    with jax.disable_jit():
        jquant = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tm = tbuild(tcb.get(arch, smoke=True), policy=policy, device="cpu")
    tp = tm.load_params(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jquant), tm.cfg))
    return jm, jquant, tm, tp


def _dequantized(tree, dtype):
    if tq.is_quantized(tree):
        return tq.dequantize_tensor(tree, dtype)
    if isinstance(tree, dict):
        return {k: _dequantized(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dequantized(v, dtype) for v in tree]
    return tree


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8"])
def test_mp_dot_on_static_int8_matches_the_reference(policy, grouped):
    rng = np.random.default_rng(3)
    lead = (3, 20) if grouped else (2, 9)
    k, n = 96, 72
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    if policy != "fp32":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    w = (rng.standard_normal(((3,) if grouped else ()) + (k, n))
         * 0.1).astype(np.float32)
    jop, top = ((jmp_dot_grouped, mp_dot_grouped) if grouped
                else (jmp_dot, mp_dot))
    with jax.disable_jit():
        jw = jq.quantize_tensor(jnp.asarray(w))
        want = jop(jnp.asarray(x), jw, policy=policy)
    tw = tq.quantize_tensor(torch.from_numpy(w))
    got = top(torch.from_numpy(x), tw, policy=policy)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               **TOL[policy])
    twin = tq.dequantize_tensor(
        tw, torch.float32 if policy != "bf16" else torch.bfloat16)
    assert torch.equal(got, top(torch.from_numpy(x), twin, policy=policy))


def test_mp_dot_names_the_operands_it_takes():
    with pytest.raises(TypeError, match="static int8"):
        mp_dot(torch.zeros(2, 4), [1, 2])
    with pytest.raises(TypeError, match="static int8"):
        mp_dot_grouped(torch.zeros(2, 2, 4), "w")


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "granite-moe-1b-a400m"])
def test_static_int8_smoke_step_matches_the_reference(arch):
    """Prefill of two left-padded rows and one decode step from the
    reference's quantized tree, bf16 policy: within 2 % of the largest
    |logit| of the reference's logits, and bit-equal to the port's model
    on the dequantized bf16 weights."""
    jm, jp, tm, tp = _pair_static(arch, "bf16")
    jp = _scannable(jp)
    twin = _dequantized(tp, torch.bfloat16)
    cfg = tm.cfg
    rng = np.random.default_rng(0)
    s = 12
    toks = rng.integers(2, cfg.vocab, (2, s + 1)).astype(np.int32)
    toks[1, :4] = 0
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len=24))(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    tb = {"tokens": torch.from_numpy(toks[:, :s])}
    tl, tc = tm.prefill(tp, tb, max_len=24)
    dl, dc = tm.prefill(twin, tb, max_len=24)
    pairs = [(tl, jl, dl)]
    tok = toks[:, s:s + 1]
    jl, _ = jax.jit(jm.decode_step)(jp, jnp.asarray(tok), jc, jnp.int32(s))
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok), tc, s)
    dl, _ = tm.decode_step(twin, torch.from_numpy(tok), dc, s)
    pairs.append((tl, jl, dl))
    for got, want, dense in pairs:
        assert torch.equal(got, dense)
        got = got.float().numpy()[:, :cfg.vocab]
        want = np.asarray(want.astype(jnp.float32))[:, :cfg.vocab]
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()


def test_load_params_moves_static_int8_uncast_and_training_refuses_it():
    cfg = tcb.get("phi3-mini-3.8b", smoke=True)
    tm = tbuild(cfg, policy="bf16", device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    quant = tm.load_params(tq.quantize_params(params, cfg=cfg))
    wq = quant["layers"][0]["attn"]["wq"]
    assert wq["q"].dtype == torch.int8 and wq["scale"].dtype == torch.float32
    assert tq.is_quantized(quant["head"])
    with pytest.raises(TypeError, match="static int8"):
        tm.train_params(quant)


def test_the_reference_faults_the_port_does_not_copy():
    """The reference's ``quantize_params`` leaves a bf16 tree as it is, and
    its ``prefill`` raises on the tree it returns for an f32 one; the port
    quantizes the bf16 weights (the same bits as their f32 values) and
    serves the result."""
    arch = "phi3-mini-3.8b"
    jm, tree = _reference_tree(arch)
    jbf16 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
        else jnp.asarray(a), tree)
    assert not list(_quantized_leaves(jq.quantize_params(jbf16)))
    jquant = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    toks = jnp.ones((1, 4), jnp.int32)
    with pytest.raises(IndexError):
        jm.prefill(jquant, {"tokens": toks}, max_len=8)
    cfg = tcb.get(arch, smoke=True)
    tm = tbuild(cfg, policy="bf16", device="cpu")
    bf16 = tm.load_params(params_from_jax(tree, cfg))
    quant = tq.quantize_params(bf16, cfg=cfg)
    assert len(list(_quantized_leaves(quant))) == 7 * cfg.n_layers + 1
    logits, _ = tm.prefill(tm.load_params(quant),
                           {"tokens": torch.ones(1, 4, dtype=torch.int32)},
                           max_len=8)
    assert torch.isfinite(logits.float()).all()
