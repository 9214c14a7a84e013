"""The port's block planner (``repro_torch.core.blocking``) against the
reference's (``repro.core.blocking``) and against the design rules.

* eq. (3): ``modeled_traffic_bytes`` is the reference's, value for value,
  on the paper's 24 Table III shapes over lattice points, densities, beta
  and epilogue operands; ``plan_with_blocks`` and ``grouped_plan_from_2d``
  give the reference's grid, traffic, FLOPs, CMR, K remainder and group
  count for the same blocks (multiples of 128 that neither package's
  clamp moves); a plan dict the reference wrote loads in the port.
* The analytic H100 plan equals the design rules (``k1_wgmma_bm``,
  ``k1_split``, ``k2_split``, ``k3_split``, ``k1_fma_tile``) at Table III in
  f32, bf16 and int8, plain and transposed, at every served model's decode
  and chunk shapes (M 1, 2, 12, 16, 32), at granite's and mixtral's grouped
  shapes, and for packed and sparse payloads -- so no launch, bit or gate
  moves with the planner.
* eq. (1): the ring's stages (``Cfg::kStages``) at its known points.
* ``pack_params`` and ``sparsify_params`` store the payloads of the
  128 x 128 rule the planner replaced, byte for byte.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import blocking as jb  # noqa: E402
from repro_torch.core import blocking as tb  # noqa: E402
from repro_torch.core.constants import H100_SMS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from benchmarks.common import PAPER_WORKLOADS  # noqa: E402

DTYPES = ("float32", "bfloat16", "int8")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# --- eq (3) and the reference's schema ---------------------------------------

@pytest.mark.parametrize("wid,m,n,k", PAPER_WORKLOADS)
def test_modeled_traffic_matches_reference(wid, m, n, k):
    for bm, bn in ((8, 128), (64, 128), (128, 128), (256, 512), (2048, 2048)):
        for a_b, b_b, c_b in ((4, 4, 4), (2, 2, 2), (1, 1, 4), (2, 0.5, 2)):
            for beta in (0.0, 1.5):
                for extra in (0, 2):
                    for density in (1.0, 0.5, 0.25):
                        args = (m, n, k, bm, bn, a_b, b_b, c_b, beta, extra,
                                density)
                        assert tb.modeled_traffic_bytes(*args) == \
                            jb.modeled_traffic_bytes(*args), args


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_with_blocks_matches_reference(dtype):
    """Blocks of multiples of 128 no larger than the shapes' extents (bm
    clamps to M = 64 in both packages alike): the same model terms, and
    grouped lifts of them."""
    fields = ("grid", "hbm_bytes", "flops", "cmr", "k_rem", "g")
    for _, m, n, k in PAPER_WORKLOADS:
        for bm in (128, 256):
            for bn in (128, 256):
                for bk in (128, 512):
                    for beta, extra, density in ((0.0, 0, 1.0),
                                                 (1.0, 1, 0.5)):
                        kw = dict(beta=beta, extra_mn_inputs=extra,
                                  density=density)
                        got = tb.plan_with_blocks(m, n, k, bm, bn, bk,
                                                  dtype, **kw)
                        want = jb.plan_with_blocks(m, n, k, bm, bn, bk,
                                                   dtype, **kw)
                        for g in (1, 8):
                            gg = tb.grouped_plan_from_2d(got, g)
                            gw = jb.grouped_plan_from_2d(want, g)
                            for f in fields:
                                assert getattr(gg, f) == getattr(gw, f), (
                                    f, m, n, k, bm, bn, bk, g)


def test_reference_plan_dict_loads():
    """A dict the reference wrote (through JSON, as its cache stores it)
    loads with the Hopper keys' defaults: design wgmma, stages 0 (no kernel
    takes it), one slice over every K tile."""
    ref = jb.plan_gemm(4096, 2112, 7168, "bfloat16")
    d = json.loads(json.dumps(jb.plan_to_dict(ref)))
    got = tb.plan_from_dict(d)
    for f in dataclasses.fields(ref):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert (got.design, got.stages, got.splits, got.per) == (
        "wgmma", 0, 1, ref.grid[2])
    with pytest.raises(ValueError, match="outside the kernel"):
        tb.check_plan(got, design="wgmma", m=4096, n=2112, k=7168,
                      a_dtype="bfloat16")
    own = tb.plan_gemm(4096, 2112, 7168, "bfloat16", g=4)
    assert tb.plan_from_dict(json.loads(json.dumps(
        tb.plan_to_dict(own)))) == own
    assert set(tb.plan_to_dict(own)) == set(jb.plan_to_dict(ref)) | {
        "design", "stages", "splits", "per"}


# --- the analytic plan against the design rules ------------------------------

def _rules(design, m, n, k, g, dtype, layout="", max_count=None):
    """The kernels' design rules for one launch: (bm, bn, splits, per)."""
    if design == "fma":
        return tb.k1_fma_tile(m, n, k, g) + (1, -(-k // tb.FMA_TILES[
            tb.k1_fma_tile(m, n, k, g)][2]))
    bm = tb.k1_wgmma_bm(m)
    if layout == "sparse":
        return (bm, min(128, n)) + tb.k3_split(m, n, max_count, g)
    if layout == "packed":
        return (bm, min(128, n)) + tb.k2_split(m, n, k, g)
    if design == "tf32x3":
        splits, per = tb.k2_split(m, n, k, g)
        return bm, 128, splits, per * 4
    return (bm, 128) + tb.k1_split(m, n, k, g, H100_SMS,
                                   tb.k1_wgmma_bk(dtype))


def _check(m, n, k, dtype, *, g=1, design=None, layout="", max_count=None,
           trans_a=False, trans_b=False, b_dtype=None):
    design = design or tb.default_design(dtype, b_dtype, layout=layout)
    plan = tb.plan_gemm(m, n, k, dtype, b_dtype, g=g, design=design,
                        layout=layout, max_count=max_count, trans_a=trans_a,
                        trans_b=trans_b)
    assert (plan.bm, plan.bn, plan.splits, plan.per) == _rules(
        design, m, n, k, g, dtype, layout, max_count), (
        design, layout, g, m, n, k, dtype, plan.describe())
    assert plan.g == g and plan.design == design
    if design == "wgmma" and not layout:
        assert plan.bk == tb.k1_wgmma_bk(dtype)
    assert tb.plan_limits(plan, design=design, m=m, n=n, k=k, g=g,
                          a_dtype=dtype, b_dtype=b_dtype, trans_a=trans_a,
                          trans_b=trans_b, layout=layout,
                          blocks=(plan.bk, plan.bn) if layout else None,
                          max_count=max_count) is None
    return plan


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_analytic_plan_equals_the_rules_at_table3(dtype, trans_a, trans_b):
    for _, m, n, k in PAPER_WORKLOADS:
        _check(m, n, k, dtype, trans_a=trans_a, trans_b=trans_b)
        if dtype == "float32":
            _check(m, n, k, dtype, design="fma", trans_a=trans_a,
                   trans_b=trans_b)


def _served_shapes():
    """{(G, K, N, f32)} of every served model's decode step (chip_smoke's
    ``_decode_gemms`` over the full depth) and its untied head."""
    from repro_torch.configs import base as cb
    smoke = _chip_smoke()
    shapes = set()
    for arch in cb.ARCH_IDS:
        cfg = cb.get(arch)
        for (g, k, n, *_, f32) in smoke._decode_gemms(cfg, cfg.n_layers):
            shapes.add((g, k, n, f32))
        shapes.add((1, cfg.d_model, cfg.vocab, False))
    return sorted(shapes)


@pytest.mark.parametrize("m", [1, 2, 12, 16, 32])
def test_analytic_plan_equals_the_rules_at_the_served_shapes(m):
    """Every served model's decode (M 1, 2) and chunk (12, 16, 32) GEMMs:
    bf16 and int8 on wgmma, the fp32 policy's on fma; the same shapes
    packed (bf16 and int8 A) and tile-sparse (several longest columns)."""
    for g, k, n, f32 in _served_shapes():
        if f32:
            _check(m, n, k, "float32", g=g, design="fma")
            continue
        for dtype in ("bfloat16", "int8"):
            _check(m, n, k, dtype, g=g)
            _check(m, n, k, dtype, g=g, layout="packed", b_dtype="int4")
            k_tiles = -(-k // 128)
            for count in {0, 1, k_tiles // 2, k_tiles}:
                _check(m, n, k, dtype, g=g, layout="sparse", b_dtype="int8",
                       max_count=count)


@pytest.mark.parametrize("g,m,n,k", [
    (32, 2, 512, 1024), (32, 2, 1024, 512), (32, 32, 512, 1024),
    (32, 160, 512, 1024), (32, 160, 1024, 512), (8, 2, 16384, 6144),
    (8, 2, 6144, 16384), (8, 32, 16384, 6144), (8, 1280, 16384, 6144),
])
def test_analytic_plan_equals_the_rules_at_the_grouped_shapes(g, m, n, k):
    """granite's and mixtral's expert stacks at decode, chunks and
    training (160 rows an expert), also transposed (the dW) and on fma."""
    for dtype in ("bfloat16", "int8"):
        _check(m, n, k, dtype, g=g)
        _check(m, n, k, dtype, g=g, trans_a=True)
        _check(m, n, k, dtype, g=g, layout="packed", b_dtype=dtype)
    _check(m, n, k, "float32", g=g, design="fma")


def test_chip_smoke_launch_shapes_keep_the_rules():
    """The K1 shapes chip_smoke.py's kernel phases time (phi3-mini's and
    granite's, M 2 and 32; the dW cases; the fma training cases): the
    analytic plan is the rules'."""
    smoke = _chip_smoke()
    for m in (2, 32):
        for _, k, n, *_ in smoke.MAIN_SHAPES:
            _check(m, n, k, "bfloat16")
        for _, k, n, dt, trans_b, _ in smoke.GRANITE_2D_SHAPES:
            _check(m, n, k, dt, trans_b=trans_b,
                   design="fma" if dt == "float32" else None)
    for _, _, m, n, dt, _, g in smoke.TRANS_A_CASES:
        t = smoke.GRANITE_TRAIN_ROWS if g else smoke.TRAIN_TOKENS
        _check(m, n, t, dt, g=g or 1, trans_a=True,
               design="fma" if dt == "float32" else None)
    for _, g, m, n, k, ta, tb_, *_ in smoke.FMA_TRAIN_CASES:
        _check(m, n, k, "float32", g=g, design="fma", trans_a=ta,
               trans_b=tb_)


# --- eq (1) and eq (2) --------------------------------------------------------

def test_wgmma_stages_and_shared_memory():
    """``Cfg::kStages``: four stages everywhere but f32 under trans_a at
    BM = 128 (its transposed lo terms), within 232,448 bytes a block."""
    for a_bytes in (1, 2, 4):
        for bm in (64, 128):
            for ta in (False, True):
                for tbb in (False, True):
                    stages = tb.wgmma_stages(bm, a_bytes, trans_a=ta,
                                             trans_b=tbb)
                    assert stages == (3 if (a_bytes, bm, ta, tbb) == (
                        4, 128, True, False) else 4)
                    assert tb.vmem_working_set(
                        bm, 128, 64, a_bytes, a_bytes, 4, trans_a=ta,
                        trans_b=tbb) <= 232448
    # bf16 at BM 64: 4 x 24 KB + barriers + 1 KB (two blocks an SM).
    assert tb.vmem_working_set(64, 128, 64, 2, 2, 2) == 4 * 24576 + 64 + 1024
    assert tb.plan_gemm(64, 128, 4096, "bfloat16").vmem_bytes == 99392


def test_block_lattice():
    assert tb.enumerate_block_lattice(32, 4096, 4096, "bfloat16") == (
        (64,), (128,), (64,))
    assert tb.enumerate_block_lattice(65, 4096, 4096, "int8") == (
        (64, 128), (128,), (128,))
    assert tb.enumerate_block_lattice(4096, 96, 96, "bfloat16", "int4",
                                      layout="packed") == (
        (64, 128), (96,), (96,))
    assert tb.enumerate_block_lattice(8, 8, 8, "float32",
                                      design="fma")[0] == (16, 32, 64, 128)
    assert tb.naive_plan(32, 3072, 3072, "bfloat16").split == (1, 48)


# --- the payloads the planner's blocks store ---------------------------------

@pytest.mark.parametrize("policy,pack_format", [("bf16", None),
                                                ("int8", None),
                                                ("bf16", "int4")])
def test_pack_params_payloads_are_the_rules(policy, pack_format):
    """``pack_params`` on the planner's blocks stores the bytes of the
    128 x 128 rule (``min(128, k)``, ``min(128, n)``), at the smoke
    config's 96-wide weights and at 3072 x 8192; the planner pins that
    tile for a packed or sparse operand at every M."""
    from repro_torch.packing.params import default_blocks, pack_params
    gen = torch.Generator().manual_seed(0)
    params = {"layers": [{"wq": torch.randn(96, 96, generator=gen),
                          "w_up": torch.randn(3072, 8192, generator=gen) / 50,
                          "w_gate": torch.randn(2, 96, 256, generator=gen)}]}

    def rule(k, n):
        return min(128, k), min(128, n)
    assert default_blocks(3072, 8192) == (128, 128)
    assert default_blocks(96, 512) == (96, 128)
    for m in (1, 64, 4096):
        for k, n in ((3072, 8192), (96, 512)):
            for lay in ("packed", "sparse"):
                plan = tb.plan_gemm(m, n, k, "bfloat16", layout=lay)
                assert (plan.bk, plan.bn) == default_blocks(k, n)
    got = pack_params(params, policy=policy, pack_format=pack_format)
    want = pack_params(params, policy=policy, pack_format=pack_format,
                       blocks=rule)
    for name in ("wq", "w_up", "w_gate"):
        a, b = got["layers"][0][name], want["layers"][0][name]
        assert a.layout == b.layout
        assert torch.equal(a.payload.view(torch.uint8),
                           b.payload.view(torch.uint8))
        assert (a.scales is None) == (b.scales is None)
        if a.scales is not None:
            assert torch.equal(a.scales, b.scales)


def test_sparsify_params_payloads_are_the_rules():
    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.sparse.layout import TileSparseOperand
    from repro_torch.sparse.params import sparsify_params
    cfg = cb.get("granite-moe-1b-a400m", smoke=True)
    model = build_model(cfg, policy="int8", device="cpu")
    draw = model.init_train(torch.Generator().manual_seed(0))
    kw = dict(cfg=cfg, density=0.5, method="nm", policy="int8")
    got = sparsify_params(draw, **kw)
    want = sparsify_params(draw, blocks=(128, 128), **kw)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tree
    pairs = list(zip(leaves(got), leaves(want)))
    assert any(isinstance(a, TileSparseOperand) for (_, a), _ in pairs)
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        if isinstance(a, TileSparseOperand):
            assert a.layout == b.layout
            assert torch.equal(a.payload, b.payload)
            assert torch.equal(a.scales, b.scales)
