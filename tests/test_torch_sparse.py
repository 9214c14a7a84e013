"""The port's tile-sparse layouts (``repro_torch.sparse``) against the JAX
package's (``repro.sparse``), on the CPU.

Both packages get the same seeded numpy weights and blocks.  The patterns
must be the reference's tile for tile (``indptr`` and ``indices`` equal)
and the payloads and scales byte for byte (f32; bf16 compared as raw bits
through ``ml_dtypes``; int8 with its per-tile f32 scales).  Tile scores are
f64 sums of squares taken in another order by numpy and torch, so they
agree to rtol = 1e-12, not bit for bit; no test input has two tiles whose
scores are that close, so the masks agree exactly.

``sparsify_params`` is held against the reference on whole models: a
two-unit stacked pattern with a tail layer (each stack position shares
one pattern across its layers, the tail layer and the head have their
own), granite's grouped expert stacks under the int8 N:M rule, and
whisper's encoder stack.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import sparse as js  # noqa: E402
from repro.configs import base as jcb  # noqa: E402
from repro.models.transformer import build_model as jbuild  # noqa: E402
from repro_torch import sparse as ts  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.packing.pack import pack_operand  # noqa: E402

# K = 300 over bk = 128: three k-tiles, the last with a 44-row tail;
# N = 200 over bn = 64: four column tiles, the last 8 wide.
K, N, BLOCKS = 300, 200, (128, 64)


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _same_payload(jp, tp):
    """Reference operand ``jp`` and port operand ``tp``: layout fields,
    indptr / indices and payload / scale bytes equal."""
    jl, tl = jp.layout, tp.layout
    for f in ("k", "n", "bk", "bn", "dtype", "orig_dtype", "indptr",
              "indices", "trans_w", "g"):
        assert getattr(jl, f) == getattr(tl, f), f
    assert tp.indptr.tolist() == list(jl.indptr)
    assert tp.indices.tolist() == list(jl.indices)
    want = np.asarray(jp.payload)
    got = tp.payload
    if tl.dtype == "bfloat16":
        assert want.dtype == ml_dtypes.bfloat16
        want, got = want.view(np.uint16), got.view(torch.int16).numpy().view(
            np.uint16)
    else:
        got = got.numpy()
    assert got.shape == want.shape == tl.payload_shape
    assert np.array_equal(got, want)
    assert (jp.scales is None) == (tp.scales is None)
    if tp.scales is not None:
        assert np.array_equal(tp.scales.numpy(), np.asarray(jp.scales))


# --- layout ------------------------------------------------------------------

LAYOUTS = {
    "2d": dict(k=300, n=200, bk=128, bn=64, indptr=(0, 2, 2, 3, 5),
               indices=(0, 2, 1, 0, 1)),
    "grouped": dict(k=40, n=24, bk=16, bn=8, g=2,
                    indptr=(0, 1, 1, 3, 3, 3, 4), indices=(2, 0, 1, 1)),
    "empty": dict(k=64, n=64, bk=32, bn=32, indptr=(0, 0, 0), indices=()),
    "trans_w": dict(k=96, n=33, bk=32, bn=16, trans_w=True,
                    indptr=(0, 3, 3, 4), indices=(0, 1, 2, 2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_properties_match_reference(case, dtype):
    kw = dict(LAYOUTS[case], dtype=dtype, orig_dtype="float32")
    jl, tl = js.TileSparseLayout(**kw), ts.TileSparseLayout(**kw)
    for f in ("nkb", "nnb", "nnz", "ntiles", "density", "per_tile_scales",
              "payload_shape", "scales_shape", "schedule_len",
              "pattern_digest", "tag"):
        assert getattr(tl, f) == getattr(jl, f), f
    assert tl.describe() == jl.describe()
    assert hash(tl) == hash(ts.TileSparseLayout(**kw))


BAD = {
    "indptr_length": dict(indptr=(0, 1, 2), indices=(0, 1)),
    "indptr_start": dict(indptr=(1, 1, 2, 2, 2), indices=(0, 1)),
    "indptr_end": dict(indptr=(0, 1, 2, 2, 3), indices=(0, 1)),
    "decreasing": dict(indptr=(0, 2, 1, 2, 2), indices=(0, 1)),
    "out_of_range": dict(indptr=(0, 1, 1, 1, 1), indices=(3,)),
    "not_ascending": dict(indptr=(0, 2, 2, 2, 2), indices=(1, 0)),
    "duplicate": dict(indptr=(0, 2, 2, 2, 2), indices=(1, 1)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_layout_validation_matches_reference(case):
    kw = dict(k=300, n=200, bk=128, bn=64, dtype="float32",
              orig_dtype="float32", **BAD[case])
    with pytest.raises(ValueError) as want:
        js.TileSparseLayout(**kw)
    with pytest.raises(ValueError) as got:
        ts.TileSparseLayout(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_build_schedule_matches_reference(case):
    kw = dict(LAYOUTS[case], dtype="float32", orig_dtype="float32")
    want = js.build_schedule(js.TileSparseLayout(**kw))
    got = ts.build_schedule(ts.TileSparseLayout(**kw))
    for f in ("kk", "jj", "gg", "slot", "first", "last"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
        assert getattr(got, f).dtype == np.int32


def test_operand_conveniences():
    w = torch.from_numpy(_w(0, (K, N)))
    op = ts.sparsify_magnitude(w, BLOCKS, density=0.5)
    assert ts.is_sparse(op) and not ts.is_sparse(w)
    assert op.shape == (K, N) and op.dtype == torch.float32
    assert op.nbytes == op.payload.numel() * 4
    assert op.indptr.dtype == op.indices.dtype == torch.int32
    half = op.astype(torch.bfloat16)
    assert half.layout.dtype == "bfloat16"
    assert half.payload.dtype == torch.bfloat16 and half.indptr is op.indptr
    assert op.astype("float32") is op
    q = ts.sparsify_magnitude(w, BLOCKS, density=0.5, dtype="int8")
    assert q.astype(torch.bfloat16) is q                # int8 stays int8
    assert q.nbytes == q.payload.numel() + 4 * q.scales.numel()
    moved = q.to("cpu")
    assert moved.layout is q.layout and torch.equal(moved.indices, q.indices)
    g = ts.sparsify_magnitude(torch.from_numpy(_w(1, (3, K, N))), BLOCKS,
                              density=0.5)
    assert g.shape == (3, K, N) and "3x300x200" in repr(g)


# --- scores and masks --------------------------------------------------------

@pytest.mark.parametrize("shape,trans_w", [((K, N), False), ((N, K), True),
                                           ((3, K, N), False),
                                           ((40, 24), False)])
def test_tile_scores_match_reference(shape, trans_w):
    w = _w(2, shape)
    want = js.tile_scores(w, BLOCKS, trans_w=trans_w)
    got = ts.tile_scores(torch.from_numpy(w), BLOCKS, trans_w=trans_w)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


def _scores(seed, shape=(3, 6, 5)):
    s = np.random.default_rng(seed).random(shape)
    s[0, 1, 2] = s[1, 3, 0] = 0.0                # prune_zero drops these
    s[-1, :, 1] = 0.25                           # ties: the stable order
    return s


@pytest.mark.parametrize("prune_zero", [True, False])
@pytest.mark.parametrize("density", [0.0, 0.3, 0.5, 0.97, 1.0])
def test_magnitude_mask_matches_reference(density, prune_zero):
    s = _scores(3)
    want = js.magnitude_mask(s, density, prune_zero=prune_zero)
    got = ts.magnitude_mask(torch.from_numpy(s), density,
                            prune_zero=prune_zero)
    assert got.dtype == bool and np.array_equal(got, want)


@pytest.mark.parametrize("prune_zero", [True, False])
@pytest.mark.parametrize("n_keep,m_block", [(1, 4), (2, 4), (3, 4), (4, 4),
                                            (2, 3)])
def test_nm_mask_matches_reference(n_keep, m_block, prune_zero):
    s = _scores(4, (2, 7, 3))
    want = js.nm_mask(s, n_keep, m_block, prune_zero=prune_zero)
    got = ts.nm_mask(s, n_keep, m_block, prune_zero=prune_zero)
    assert np.array_equal(got, want)


def test_mask_arguments_are_checked():
    with pytest.raises(ValueError, match="density"):
        ts.magnitude_mask(_scores(0), 1.5)
    with pytest.raises(ValueError, match="n_keep"):
        ts.nm_mask(_scores(0), 5, 4)
    with pytest.raises(ValueError, match="keep mask shape"):
        ts.sparsify_with_mask(torch.ones(K, N), BLOCKS, np.ones((2, 2)))


# --- operands ----------------------------------------------------------------

def _keep(seed, shape):
    keep = np.random.default_rng(seed).random(shape) < 0.5
    keep[..., 1] = False                         # an empty column
    keep[..., 0, 0] = True
    keep[..., -1, -1] = True                     # the K- and N-tail tile
    return keep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape,trans_w", [((K, N), False), ((N, K), True),
                                           ((3, K, N), False)])
def test_sparsify_with_mask_is_byte_identical(shape, trans_w, dtype):
    w = _w(5, shape)
    lattice = (3, 4) if len(shape) == 2 else (3, 3, 4)
    keep = _keep(6, lattice)
    want = js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep,
                                 trans_w=trans_w, dtype=dtype)
    got = ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                                trans_w=trans_w, dtype=dtype)
    _same_payload(want, got)
    assert got.payload[-1].abs().sum() == 0      # the trailing zero tile
    if dtype == "int8":
        assert got.scales[-1].item() == 1.0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fully_empty_operand(dtype):
    w = _w(7, (K, N))
    keep = np.zeros((3, 4), bool)
    want = js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep, dtype=dtype)
    got = ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                                dtype=dtype)
    _same_payload(want, got)
    assert got.layout.nnz == 0 and got.payload.shape == (1, 128, 64)
    assert torch.equal(ts.densify_operand(got), torch.zeros(K, N))


@pytest.mark.parametrize("method", ["magnitude", "nm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sparsifiers_are_byte_identical(method, dtype):
    w = _w(8, (2, 520, 200))                     # nkb = 5: a partial N:M run
    if method == "magnitude":
        want = js.sparsify_magnitude(jnp.asarray(w), BLOCKS, density=0.4,
                                     dtype=dtype)
        got = ts.sparsify_magnitude(torch.from_numpy(w), BLOCKS,
                                    density=0.4, dtype=dtype)
    else:
        want = js.sparsify_nm(jnp.asarray(w), BLOCKS, n_keep=2, m_block=4,
                              dtype=dtype)
        got = ts.sparsify_nm(torch.from_numpy(w), BLOCKS, n_keep=2,
                             m_block=4, dtype=dtype)
    _same_payload(want, got)


def test_pruned_zero_tiles_are_dropped_at_full_density():
    w = _w(9, (K, N))
    w[128:256, 64:128] = 0.0
    got = ts.sparsify_magnitude(torch.from_numpy(w), BLOCKS, density=1.0)
    want = js.sparsify_magnitude(jnp.asarray(w), BLOCKS, density=1.0)
    _same_payload(want, got)
    assert got.layout.nnz == 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape,trans_w", [((K, N), False), ((N, K), True),
                                           ((3, K, N), False)])
def test_densify_operand_matches_reference(shape, trans_w, dtype):
    w = _w(10, shape)
    keep = _keep(11, (3, 4) if len(shape) == 2 else (3, 3, 4))
    jp = js.sparsify_with_mask(jnp.asarray(w), BLOCKS, keep, trans_w=trans_w,
                               dtype=dtype)
    tp = ts.sparsify_with_mask(torch.from_numpy(w), BLOCKS, keep,
                               trans_w=trans_w, dtype=dtype)
    want = np.asarray(js.densify_operand(jp).astype(jnp.float32))
    got = ts.densify_operand(tp)
    assert got.dtype == (torch.float32 if dtype != "bfloat16"
                         else torch.bfloat16)
    assert np.array_equal(got.float().numpy(), want)
    f32 = ts.densify_operand(tp, dtype=torch.float32)
    assert f32.dtype == torch.float32


def test_build_payload_uses_the_packer():
    """The payload is the packer's tiles of the stored positions, so the
    sparse int8 codec is the packed one."""
    w = torch.from_numpy(_w(12, (K, N)))
    op = ts.sparsify_magnitude(w, BLOCKS, density=0.5, dtype="int8")
    packed = pack_operand(w, BLOCKS, dtype="int8")
    lay = op.layout
    for t in range(lay.nnz):
        c = int(np.searchsorted(np.asarray(lay.indptr), t, side="right")) - 1
        kk = lay.indices[t]
        assert torch.equal(op.payload[t], packed.payload[kk, c])
        assert op.scales[t, 0] == packed.scales[kk, c]


# --- whole models ------------------------------------------------------------

# Two units of (dense, attn_local) in the reference's stack, then a tail
# dense layer; an odd vocab gives a padded, untied head.
STACKED = dict(block_pattern=("dense", "attn_local", "dense", "attn_local",
                              "dense"),
               local_attn_window=5, vocab=500, n_layers=5)
MODELS = {
    "stacked": ("phi3-mini-3.8b", STACKED),
    "granite": ("granite-moe-1b-a400m", {}),
    "whisper": ("whisper-medium", {}),
}


def _model(name, seed=0):
    arch, over = MODELS[name]
    jc, tc = jcb.get(arch, smoke=True), tcb.get(arch, smoke=True)
    if over:
        jc = dataclasses.replace(jc, name=name, **over)
        tc = dataclasses.replace(tc, name=name, **over)
    jm = jbuild(jc, policy="fp32", remat=False)
    if arch == "whisper-medium":        # the port reads the decoder pattern
        tc = dataclasses.replace(tc, block_pattern=jm.cfg.pattern)
    return jm.init(jax.random.PRNGKey(seed)), tc


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name,policy,method,blocks", [
    ("stacked", "bf16", "magnitude", (32, 32)),
    ("stacked", "int8", "nm", (16, 32)),
    ("stacked", "fp32", "magnitude", (48, 16)),
    ("granite", "int8", "nm", (16, 16)),
    ("granite", "bf16", "magnitude", (32, 16)),
    ("whisper", "bf16", "magnitude", (32, 64)),
])
def test_sparsify_params_matches_reference(name, policy, method, blocks):
    jp, tc = _model(name)
    kw = dict(density=0.5, method=method, nm=(2, 4), policy=policy,
              blocks=blocks)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, js.sparsify_params(jp, **kw)), tc)
    dense = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    got = ts.sparsify_params(dense, cfg=tc, **kw)
    flat_w, flat_g = dict(_flat(want)), dict(_flat(got))
    assert flat_w.keys() == flat_g.keys()
    n_sparse = 0
    for path, w in flat_w.items():
        g = flat_g[path]
        assert isinstance(g, ts.TileSparseOperand) == isinstance(
            w, ts.TileSparseOperand), path
        if isinstance(g, ts.TileSparseOperand):
            n_sparse += 1
            assert g.layout == w.layout, path
            assert torch.equal(g.payload.view(torch.uint8).flatten(),
                               w.payload.view(torch.uint8).flatten()), path
            assert (g.scales is None) == (w.scales is None)
            if g.scales is not None:
                assert torch.equal(g.scales, w.scales), path
        else:
            assert torch.equal(g, w), path
    assert n_sparse > 0
    assert ts.sparse_param_bytes(got) == ts.sparse_param_bytes(want) == \
        js.sparse_param_bytes(js.sparsify_params(jp, **kw))
    assert ts.sparse_param_density(got, tc) == ts.sparse_param_density(
        want, tc)
    # Routers, norms and embeddings stay dense.
    assert isinstance(got["embed"], torch.Tensor)
    if name == "granite":
        assert isinstance(got["layers"][0]["router"], torch.Tensor)
        assert got["layers"][0]["w_up"].layout.g == tc.n_experts


def test_sparsify_params_shares_patterns_within_each_stack():
    """Layers 0, 2 (stack position 0) share one pattern, layers 1, 3
    (position 1) another; the tail layer 4 and the head have their own."""
    jp, tc = _model("stacked")
    dense = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    got = ts.sparsify_params(dense, cfg=tc, density=0.5, blocks=(16, 16))

    def layout(i):
        return got["layers"][i]["mlp"]["w_up"].layout

    assert layout(0) == layout(2) and layout(1) == layout(3)
    patterns = {layout(i).indices for i in range(5)}
    assert len(patterns) == 3                  # 0=2, 1=3, and the tail 4
    alone = ts.sparsify_params({"head": dense["head"]}, cfg=tc, density=0.5,
                               blocks=(16, 16))
    assert got["head"].layout == alone["head"].layout


def test_sparsify_params_refuses_an_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        ts.sparsify_params({"wq": torch.ones(4, 4)},
                           cfg=tcb.get("phi3-mini-3.8b", smoke=True),
                           method="random")


@pytest.mark.parametrize("sparsity,want", [(0.5, (2, 4)), (0.3, (3, 4)),
                                           (0.9, (1, 4)), (0.05, (4, 4))])
def test_nm_rule_matches_the_reference_cli(sparsity, want):
    assert ts.nm_for_sparsity(sparsity) == want
    assert max(1, round((1.0 - sparsity) * 4)) == want[0]
