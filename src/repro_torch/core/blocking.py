"""Analytic block planner for the H100 (port of ``repro.core.blocking``,
the paper's cache-aware partitioning of Section IV-B, equations (1)-(3),
re-derived for Hopper).

  paper eq (1): working set of packed blocks < shared L2
      -> here: one block's shared memory -- the ring of TMA stages, the
         buffers that hold transposed or decoded tiles, the ring's
         mbarriers -- within the 232,448 bytes a block may take.  The
         ring's depth is the kernel's own ``Cfg::kStages``
         (``csrc/mpgemm_wgmma.cuh``), written once here
         (:func:`wgmma_stages`, :func:`vmem_working_set`).

  paper eq (2): TLB-entry bound on kc
      -> TMA's 128-byte swizzle row and wgmma's granularity fix the
         lattice: bk is one 128-byte row of A's K (:func:`k1_wgmma_bk`),
         bm is 64 or 128 (one or two consumer warpgroups of 64 rows), bn
         is 128; a packed or tile-sparse B pins (bk, bn) to its payload
         tile (128 x 128, clamped to the extent).  The ``fma`` design's
         tiles are :data:`FMA_TILES`.

  paper eq (3): maximize compute-to-memory ratio (CMR)
      -> the same objective and the same traffic formula
         (:func:`modeled_traffic_bytes`).  Over the lattice it picks bm =
         128 whenever M needs more than one 64-row block (:func:`k1_wgmma_bm`).

Hopper adds one decision the TPU grid did not have: with fewer output tiles
than SMs, K is cut into slices that run on other SMs and are summed in
slice order (:func:`k1_split`, :func:`k2_split`, :func:`k3_split`).  The
plan carries it as ``(splits, per)``, with the design that runs it and the
ring's stages.  The analytic plan equals these design rules at every shape,
so that a launch without a tuned plan runs the same kernel, bits and all,
as before the planner; ``repro_torch.tuning`` measures other candidates
and stores the winner in the plan cache, and every launch in
``kernels/mpgemm.py`` reads its plan from there.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

from repro_torch.core.codecs import (
    canonical_payload_dtype, dtype_bits, dtype_bytes, dtype_name, get_codec,
)
from repro_torch.core.constants import (
    DEFAULT_HW, H100_SMS, SMEM_BLOCK_BYTES, TMA_ROW_BYTES, WGMMA_BK,
    WGMMA_BK_F32, WGMMA_BK_INT8, WGMMA_BN, WGMMA_M, WGMMA_PAYLOAD_TILE,
    HardwareSpec,
)

# The kernels a plan can name: K1's wgmma (bf16, int8; also K2's and K3's
# tensor-core design), tf32x3 (K1 f32 on the tensor cores), fma (K1 f32 on
# the CUDA cores) and simt (the scalar kernels, which take no blocks).
DESIGNS = ("wgmma", "tf32x3", "fma", "simt")
# Where B comes from: a dense operand (K1), a packed payload (K2) or a
# tile-sparse one (K3).
LAYOUTS = ("", "packed", "sparse")


def _dtype_bytes(dtype):
    """Bytes per element -- fractional for sub-byte payload codecs (int4
    moves half a byte of device memory per weight element)."""
    return dtype_bytes(dtype)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """A fully-specified blocking decision for one (possibly grouped) GEMM.

    The reference's fields, with ``vmem_bytes`` the block's shared memory
    (eq. (1)), then what a Hopper launch also needs: the ``design`` that
    runs it, the ring's ``stages``, and the split over K -- ``splits``
    slices of ``per`` K tiles of ``bk`` each (K3: ``per`` stored tiles of a
    column).  ``g > 1`` marks a grouped instance; ``flops``/``hbm_bytes``
    cover all G groups.  A plan written by the reference loads with the
    defaults of the new fields, and no kernel takes it (its stages are 0).
    """

    m: int
    n: int
    k: int
    bm: int
    bn: int
    bk: int
    a_dtype: str
    b_dtype: str
    out_dtype: str
    acc_dtype: str
    # Derived.
    grid: Tuple[int, int, int]
    vmem_bytes: int          # modeled shared memory of one block
    hbm_bytes: int           # modeled device-memory traffic, whole GEMM
    flops: int               # 2*G*M*N*K
    cmr: float               # flops / hbm_bytes (the paper's eq (3) value)
    k_rem: int               # K % bk (0 -> no K-edge predication needed)
    notes: str = ""
    g: int = 1               # group/batch count (1 == plain 2-D GEMM)
    design: str = "wgmma"
    stages: int = 0
    splits: int = 1
    per: int = 0

    @property
    def arithmetic_intensity(self) -> float:
        return self.cmr

    @property
    def split(self) -> Tuple[int, int]:
        return self.splits, self.per

    def describe(self) -> str:
        shape = f"{self.m}x{self.n}x{self.k}"
        if self.g != 1:
            shape = f"{self.g}x" + shape
        return (
            f"GemmPlan[{shape} {self.a_dtype}->{self.out_dtype} "
            f"{self.design}] blocks=({self.bm},{self.bn},{self.bk}) "
            f"split={self.splits}x{self.per} stages={self.stages} "
            f"grid={self.grid} smem={self.vmem_bytes / 2**10:.1f}KiB "
            f"CMR={self.cmr:.1f} {self.notes}"
        )


def _resolve_dtypes(a_dtype, b_dtype=None, out_dtype=None, acc_dtype=None):
    """Canonical (a, b, out, acc) dtype strings under the policy defaults,
    as the reference's: int inputs sum in int32 into an int32 output; float
    inputs sum in f32 into their own dtype; a payload codec B keeps its
    name (``int4``, ``fp8e4m3``) and sums in f32 (per-tile scales), an int8
    payload in int32 against int8 A."""
    a = dtype_name(a_dtype)
    b = canonical_payload_dtype(b_dtype if b_dtype is not None else a)
    integer = a.startswith("int")
    out = dtype_name(out_dtype) if out_dtype is not None else (
        "int32" if integer else a)
    if acc_dtype is None:
        codec = get_codec(b)
        if codec is not None and codec.name != "int8":
            acc = "float32"
        else:
            acc = "int32" if integer else "float32"
    else:
        acc = dtype_name(acc_dtype)
    return a, b, out, acc


# --- eq (2): the lattice -----------------------------------------------------

def k1_wgmma_bk(dtype) -> int:
    """The wgmma design's K tile for operands of ``dtype`` (a torch dtype
    or its name): one 128-byte TMA row."""
    name = dtype_name(dtype)
    return {"int8": WGMMA_BK_INT8, "float32": WGMMA_BK_F32}.get(name,
                                                               WGMMA_BK)


def k1_wgmma_bm(m: int) -> int:
    """The wgmma design's tile rows: one consumer warpgroup (64) for M <=
    64, else two (128).  It is eq. (3) over the lattice {64, 128}: 128 reads
    B half as often once M needs two 64-row blocks, and for M <= 64 the
    lattice holds only 64 (:func:`enumerate_block_lattice`)."""
    return WGMMA_M if m <= WGMMA_M else 2 * WGMMA_M


# The fma design's tiles (csrc/mpgemm_fma.cu), from the largest: (BM, BN)
# -> (TM, TN, BK, stages, rate): the outputs a thread computes, the depth
# of a stage, the stages of the ring, and the outputs an SM finishes in a
# unit of time, relative to the 64 x 64 tile's, when it holds enough
# blocks of the tile: the 128-row tile reuses each value over more
# outputs, the small ones spread a small output over more SMs.  The rates
# make k1_fma_tile pick, at Table III's and granite's training shapes,
# the tile that ran fastest when each tile was timed at each shape on an
# H100.
FMA_TILES = {(128, 128): (8, 8, 16, 3, 1.3), (64, 64): (4, 4, 16, 4, 1.0),
             (32, 32): (2, 2, 16, 4, 0.6), (16, 4): (1, 1, 128, 4, 0.2)}


@functools.lru_cache(maxsize=4096)
def k1_fma_tile(m: int, n: int, k: int, g: int = 1,
                sms: int = H100_SMS) -> tuple:
    """(BM, BN) of the ``fma`` design for an (M, N) output over K of
    ``g`` groups, from the shape alone: 16 x 4 for M <= 16 (decode and
    short chunks: one output a thread, so that a narrow output still
    spreads over many SMs -- granite's router, N = 32, over 8 blocks);
    else the tile of :data:`FMA_TILES` whose grid the ``sms`` SMs finish
    first: the blocks an SM takes (rounded up) times a block's outputs
    over the tile's rate, the larger tile on a tie.  No tile splits K:
    each output is one thread's chain."""
    if m <= 16:
        return 16, 4

    def cost(tile):
        bm, bn = tile
        blocks = g * _cdiv(m, bm) * _cdiv(n, bn)
        return _cdiv(blocks, sms) * bm * bn / FMA_TILES[tile][-1]

    return min(FMA_TILES, key=cost)


def default_design(a_dtype, b_dtype=None, *, layout: str = "",
                   f32_fma: bool = False) -> str:
    """The design an aligned launch of these dtypes runs (the kernel
    layer's ``k1_design`` / ``k2_design`` / ``k3_design`` decide a real
    launch from its operands and pass it in): bf16 and int8 A on wgmma, f32
    A on tf32x3 (``fma`` under ``f32_fma``) against a dense B and on the
    scalar kernels against a payload."""
    a = dtype_name(a_dtype)
    if a in ("bfloat16", "int8"):
        return "wgmma"
    if a == "float32" and not layout:
        return "fma" if f32_fma else "tf32x3"
    return "simt"


def enumerate_block_lattice(
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    *,
    hw: HardwareSpec = DEFAULT_HW,
    max_block: int = 2048,
    design: Optional[str] = None,
    layout: str = "",
    blocks: Optional[Tuple[int, int]] = None,
) -> Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]:
    """The candidate lattice (bm, bn, bk) the planner searches, eq. (2):
    bm from wgmma's 64-row granularity up to two warpgroups (only 64 where
    M fits in 64 rows), bn one wgmma tile (128), bk one TMA row of A's K;
    a packed or sparse B pins (bk, bn) to its payload's ``blocks``
    (default: the tile the wgmma designs read, clamped to the extent).  The ``fma`` design's axes are those of :data:`FMA_TILES`
    (whose pairs, not their product, are its tiles).  ``max_block`` is the
    reference's; no Hopper block reaches it.
    ``repro_torch.tuning.microbench`` sweeps this lattice, so a measured
    plan never leaves the space the kernel supports."""
    a, b, _, _ = _resolve_dtypes(a_dtype, b_dtype)
    design = design or default_design(a, b, layout=layout)
    if design == "fma":
        return (tuple(sorted({t[0] for t in FMA_TILES})),
                tuple(sorted({t[1] for t in FMA_TILES})),
                tuple(sorted({v[2] for v in FMA_TILES.values()})))
    bm = tuple(c for c in (hw.wgmma_m, 2 * hw.wgmma_m)
               if c <= max(hw.wgmma_m, _round_up(m, hw.wgmma_m))
               and c <= max_block)
    if layout:
        tk, tn = blocks or WGMMA_PAYLOAD_TILE
        return bm, (min(tn, n),), (min(tk, k),)
    return bm, (hw.wgmma_bn,), (hw.tma_row_bytes * 8 // dtype_bits(a),)


# --- eq (1): the block's shared memory ---------------------------------------

def _wgmma_buffers(bm: int, a_bytes, b_bytes, trans_a: bool, trans_b: bool,
                   packed: bool) -> Tuple[int, int]:
    """(bytes of a ring stage, bytes of the transposed / decoded buffers)
    of ``Cfg<BM, T, TRANS_A, TRANS_B, P>`` in csrc/mpgemm_wgmma.cuh: a
    stage is one 128-byte row of A's K for BM rows plus B's tile for it
    (a codec payload raw, its decoded tile in a buffer); int8 keeps
    K-major copies of MN-major tiles (three buffers), f32 its tf32 lo
    terms (two sets).  K2 and K3 (``packed``) read A (M, K): no
    transposes."""
    row, bn = TMA_ROW_BYTES, WGMMA_BN
    if packed:
        trans_a = trans_b = False
    f32, int8 = a_bytes == 4 and not packed, a_bytes == 1
    decode = packed and b_bytes != 2
    a_stage = bm * row
    b_stage = int(row // a_bytes * bn * b_bytes) if decode else bn * row
    if f32:
        buffers = 2 * ((2 if trans_a else 1) * a_stage
                       + (1 if trans_b else 2) * bn * row)
    else:
        buffers = 3 * ((a_stage if int8 and trans_a else 0)
                       + (bn * row if (int8 and not trans_b) or decode
                          else 0))
    return a_stage + b_stage, buffers


def wgmma_stages(bm: int, a_bytes, b_bytes=None, *, trans_a: bool = False,
                 trans_b: bool = False, packed: bool = False) -> int:
    """``Cfg::kStages``: a ring of 4 stages, or 3 where 4 and the buffers
    (with 2 KB for the barriers and the swizzle's alignment) pass the
    block's 232,448 bytes (f32 under ``trans_a`` at BM = 128).  The card
    test ``test_wgmma_stages_match_the_compiled_kernel`` holds this to the
    value each compiled library reports."""
    stage, buffers = _wgmma_buffers(bm, a_bytes, a_bytes if b_bytes is None
                                    else b_bytes, trans_a, trans_b, packed)
    return 4 if 4 * stage + buffers + 2048 <= SMEM_BLOCK_BYTES else 3


def vmem_working_set(
    bm: int, bn: int, bk: int,
    a_bytes, b_bytes, out_bytes, acc_bytes=4,
    beta: float = 0.0, extra_mn_inputs: int = 0,
    *, design: str = "wgmma", trans_a: bool = False, trans_b: bool = False,
    packed: bool = False, stages: Optional[int] = None,
) -> int:
    """Paper eq (1), shared-memory form: the bytes one block takes.

    wgmma and tf32x3 (``Cfg::kSmemBytes``): the ring of ``stages`` (default
    :func:`wgmma_stages`), the transposed or decoded buffers, two mbarriers
    a stage and 1 KB to align the ring to the swizzle pattern.  The
    accumulators live in registers and the output tile reuses the ring, so
    ``out_bytes``, ``acc_bytes``, ``beta`` and the epilogue operands (read
    from device memory in the epilogue) add nothing; a stage is one TMA row
    of A's K whatever ``bk`` is (a K2 plan's bk is its 128-deep payload
    tile, two stages for bf16 A).  fma: its ring of (BM + BN) x (BK + 4)
    f32 a stage (the model's pad; ``csrc/mpgemm_fma.cu``).  simt: 0 (the
    scalar kernels size their own tiles)."""
    if design == "fma":
        stages = stages if stages is not None else FMA_TILES[(bm, bn)][3]
        return stages * (bm + bn) * (bk + 4) * 4
    if design == "simt":
        return 0
    if stages is None:
        stages = wgmma_stages(bm, a_bytes, b_bytes, trans_a=trans_a,
                              trans_b=trans_b, packed=packed)
    stage, buffers = _wgmma_buffers(bm, a_bytes, b_bytes, trans_a, trans_b,
                                    packed)
    return stages * stage + buffers + 2 * stages * 8 + 1024


# --- eq (3): traffic ---------------------------------------------------------

def modeled_traffic_bytes(
    m: int, n: int, k: int, bm: int, bn: int,
    a_bytes: float, b_bytes: float, c_bytes: float, beta: float = 0.0,
    extra_mn_inputs: int = 0, density: float = 1.0,
) -> int:
    """Device-memory traffic of a grid whose blocks each sweep K (the
    reference's formula, value for value): A is read once per column-block
    of C, B once per row-block, C written once (and read once iff beta !=
    0); each extra (M, N) epilogue operand is read once.  Byte counts may be
    fractional (int4: 0.5).  ``density`` < 1 prices a tile-sparse B: only
    stored tiles, and the A blocks they meet, are read."""
    n_col_blocks = math.ceil(n / bn)
    n_row_blocks = math.ceil(m / bm)
    c_factor = 2 if beta else 1
    return int(
        m * k * a_bytes * n_col_blocks * density
        + k * n * b_bytes * n_row_blocks * density
        + m * n * c_bytes * (c_factor + extra_mn_inputs)
    )


# --- the split over K --------------------------------------------------------

def _wgmma_tiles(m: int, n: int, g: int, bm: Optional[int]) -> int:
    return g * _cdiv(m, bm or k1_wgmma_bm(m)) * _cdiv(n, WGMMA_BN)


@functools.lru_cache(maxsize=4096)
def k1_split(m: int, n: int, k: int, g: int = 1,
             sms: int = H100_SMS, bk: int = WGMMA_BK,
             bm: Optional[int] = None) -> tuple:
    """(slices, K tiles a slice) of the wgmma design's split over K: with
    fewer output tiles (``bm`` rows, default :func:`k1_wgmma_bm`) than
    ``sms``, K is cut into slices so that tiles x slices reaches ``sms``
    where K allows, every slice at least one K tile (``bk`` deep:
    :func:`k1_wgmma_bk`) and none empty; else one slice.  The kernel sums
    the slices in slice order, so the result is the same bits every run."""
    tiles = _wgmma_tiles(m, n, g, bm)
    k_tiles = max(1, _cdiv(k, bk))
    want = min(_cdiv(sms, tiles), k_tiles) if tiles < sms else 1
    per = k_tiles // want            # slices of ``per``: at least ``want``
    return _cdiv(k_tiles, per), per


@functools.lru_cache(maxsize=4096)
def k2_split(m: int, n: int, k: int, g: int = 1,
             sms: int = H100_SMS, bm: Optional[int] = None) -> tuple:
    """(slices, payload tiles a slice) of K2's wgmma design: as
    :func:`k1_split` over 128-deep payload tiles, but the grid never
    passes one wave of ``sms`` blocks (a K2 block holds an SM: its decoded
    tiles take the shared memory a second block would need), so the
    slices are as many as fit in the SMs beside the output tiles, every
    slice whole tiles and none empty; one slice when the output tiles
    alone fill the card."""
    tiles = _wgmma_tiles(m, n, g, bm)
    k_tiles = max(1, _cdiv(k, 128))
    want = max(1, min(sms // tiles, k_tiles))
    per = _cdiv(k_tiles, want)
    return _cdiv(k_tiles, per), per


@functools.lru_cache(maxsize=4096)
def k3_split(m: int, n: int, max_count: int, g: int = 1,
             sms: int = H100_SMS, bm: Optional[int] = None) -> tuple:
    """(slices, stored tiles a slice) of K3's wgmma design: as
    :func:`k2_split` with ``max_count``, the most stored tiles of any
    output column (``TileSparseLayout.max_column_tiles``), in place of the
    K tiles -- one wave of ``sms`` blocks, every slice whole stored tiles,
    the last slice of the longest column not empty.  A column with fewer
    tiles leaves its later slices empty: they count themselves in with a
    zero partial."""
    tiles = _wgmma_tiles(m, n, g, bm)
    count = max(1, max_count)
    want = max(1, min(sms // tiles, count))
    per = _cdiv(count, want)
    return _cdiv(count, per), per


def _split_total(design: str, k: int, bk: int, layout: str,
                 max_count: Optional[int]) -> int:
    """The units a plan's ``per`` counts: stored tiles of the longest
    column (K3), else K tiles of ``bk``."""
    if layout == "sparse" and design == "wgmma":
        return max(1, max_count if max_count is not None else _cdiv(k, bk))
    return max(1, _cdiv(k, bk))


def analytic_split(design: str, m: int, n: int, k: int, bm: int, bk: int,
                   *, g: int = 1, sms: int = H100_SMS, layout: str = "",
                   max_count: Optional[int] = None) -> Tuple[int, int]:
    """(splits, per) the design rules give: :func:`k1_split` (wgmma, dense
    B), :func:`k2_split` (K2, and tf32x3 in 32-deep stages: its split
    keeps whole 128-deep folds in one wave), :func:`k3_split` (K3); one
    slice for fma and simt."""
    if design == "wgmma" and layout == "sparse":
        return k3_split(m, n, _split_total(design, k, bk, layout, max_count),
                        g, sms, bm)
    if design == "wgmma" and layout == "packed":
        return k2_split(m, n, k, g, sms, bm)
    if design == "wgmma":
        return k1_split(m, n, k, g, sms, bk, bm)
    if design == "tf32x3":
        splits, per = k2_split(m, n, k, g, sms, bm)
        return splits, per * (128 // bk)
    return 1, _split_total(design, k, bk, layout, max_count)


def _design_stages(design: str, bm: int, bn: int, a_dtype, b_dtype,
                   trans_a: bool, trans_b: bool, layout: str) -> int:
    if design in ("wgmma", "tf32x3"):
        return wgmma_stages(bm, _dtype_bytes(a_dtype), _dtype_bytes(b_dtype),
                            trans_a=trans_a, trans_b=trans_b,
                            packed=bool(layout))
    if design == "fma":
        return FMA_TILES[(bm, bn)][3]
    return 0


# --- the plans ---------------------------------------------------------------

def plan_gemm(
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    acc_dtype=None,
    *,
    beta: float = 0.0,
    extra_mn_inputs: int = 0,
    density: float = 1.0,
    hw: HardwareSpec = DEFAULT_HW,
    vmem_budget_frac: float = 1.0,
    max_block: int = 2048,
    g: int = 1,
    design: Optional[str] = None,
    trans_a: bool = False,
    trans_b: bool = False,
    layout: str = "",
    max_count: Optional[int] = None,
    blocks: Optional[Tuple[int, int]] = None,
) -> GemmPlan:
    """The analytic plan for an M x N x K GEMM (``g`` groups of it).

    The paper's flow on Hopper: the lattice from TMA and wgmma (eq. (2)),
    the shared-memory bound (eq. (1), within ``vmem_budget_frac`` of the
    block's 232,448 bytes), the largest CMR (eq. (3); fewer grid steps,
    then the squarer block, on a tie); then the split over K for ``g``
    groups on ``hw.sms`` SMs by the design's rule.  ``design`` is the
    launch's (default :func:`default_design`); ``layout`` is ``"packed"``
    (K2) or ``"sparse"`` (K3, whose split reads ``max_count``, the longest
    column's stored tiles), whose payload's ``blocks`` = (bk, bn) pin the
    plan's (the reference's ``_layout_plan``); ``trans_a``/``trans_b`` size
    the transposed buffers.  The ``fma`` design's tile is :func:`k1_fma_tile`'s.
    ``density`` < 1 prices a tile-sparse B.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; valid: {LAYOUTS}")
    a_dtype, b_dtype, out_dtype, acc_dtype = _resolve_dtypes(
        a_dtype, b_dtype, out_dtype, acc_dtype)
    design = design or default_design(a_dtype, b_dtype, layout=layout)
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}; valid: {DESIGNS}")
    kw = dict(beta=beta, extra_mn_inputs=extra_mn_inputs, density=density,
              hw=hw, design=design, trans_a=trans_a, trans_b=trans_b,
              layout=layout, max_count=max_count)
    if design == "fma":
        bm, bn = k1_fma_tile(m, n, k, g, hw.sms)
        plan = plan_with_blocks(m, n, k, bm, bn, FMA_TILES[(bm, bn)][2],
                                a_dtype, b_dtype, out_dtype, acc_dtype,
                                g=g, **kw)
        return grouped_plan_from_2d(plan, g)
    ab, bb, ob = (_dtype_bytes(a_dtype), _dtype_bytes(b_dtype),
                  _dtype_bytes(out_dtype))
    budget = int(hw.smem_bytes * vmem_budget_frac)
    best = None
    bm_c, bn_c, bk_c = enumerate_block_lattice(
        m, n, k, a_dtype, b_dtype, hw=hw, max_block=max_block,
        design=design, layout=layout, blocks=blocks)
    for bm in bm_c:
        for bn in bn_c:
            for bk in bk_c:
                ws = vmem_working_set(bm, bn, bk, ab, bb, ob, design=design,
                                      trans_a=trans_a, trans_b=trans_b,
                                      packed=bool(layout))
                if ws > budget:
                    continue
                traffic = modeled_traffic_bytes(m, n, k, bm, bn, ab, bb, ob,
                                                beta, extra_mn_inputs,
                                                density)
                cmr = int(2 * m * n * k * density) / max(1, traffic)
                grid_steps = (math.ceil(m / bm) * math.ceil(n / bn)
                              * math.ceil(k / bk))
                key = (cmr, -grid_steps, min(bm, bn))
                if best is None or key > best[0]:
                    best = (key, (bm, bn, bk))
    if best is None:
        raise ValueError(f"no block of the {design} lattice fits "
                         f"{budget} bytes of shared memory")
    plan = plan_with_blocks(m, n, k, *best[1], a_dtype, b_dtype, out_dtype,
                            acc_dtype, g=g, **kw)
    return grouped_plan_from_2d(plan, g)


def plan_with_blocks(
    m: int,
    n: int,
    k: int,
    bm: int,
    bn: int,
    bk: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    acc_dtype=None,
    *,
    beta: float = 0.0,
    extra_mn_inputs: int = 0,
    density: float = 1.0,
    hw: HardwareSpec = DEFAULT_HW,
    notes: str = "",
    design: Optional[str] = None,
    splits: Optional[int] = None,
    per: Optional[int] = None,
    g: int = 1,
    trans_a: bool = False,
    trans_b: bool = False,
    layout: str = "",
    max_count: Optional[int] = None,
) -> GemmPlan:
    """Price one lattice point: a 2-D :class:`GemmPlan` for *forced* (bm,
    bn, bk) and, optionally, a forced split ``(splits, per)`` (default: the
    design's rule for these blocks, ``g`` groups and ``hw.sms``).

    The wgmma lattice's blocks are clamped to the problem's aligned extent
    (bm to 64-row multiples, a payload tile to the extent); fma and simt
    blocks are kept as given.  Grid, shared memory, traffic, CMR and
    K-edge predication are recomputed as the reference's are, so a tuned
    plan carries the same metadata as an analytic one.  The tuner
    (``repro_torch.tuning``) is the main caller; the result is lifted to
    ``g`` groups by :func:`grouped_plan_from_2d`.
    """
    a_dtype, b_dtype, out_dtype, acc_dtype = _resolve_dtypes(
        a_dtype, b_dtype, out_dtype, acc_dtype)
    design = design or default_design(a_dtype, b_dtype, layout=layout)
    ab = _dtype_bytes(a_dtype)
    bb = _dtype_bytes(b_dtype)
    ob = _dtype_bytes(out_dtype)
    if design in ("wgmma", "tf32x3", "simt"):
        bm = min(bm, max(hw.wgmma_m, _round_up(m, hw.wgmma_m)))
        if layout:
            bn, bk = min(bn, n), min(bk, k)
        else:
            bn = min(bn, _round_up(n, hw.wgmma_bn))
            bk = min(bk, _round_up(k, bk))
    stages = _design_stages(design, bm, bn, a_dtype, b_dtype, trans_a,
                            trans_b, layout)
    ws = vmem_working_set(bm, bn, bk, ab, bb, ob, design=design,
                          trans_a=trans_a, trans_b=trans_b,
                          packed=bool(layout), stages=stages or None)
    if splits is None or per is None:
        splits, per = analytic_split(design, m, n, k, bm, bk, g=g,
                                     sms=hw.sms, layout=layout,
                                     max_count=max_count)
    traffic = modeled_traffic_bytes(m, n, k, bm, bn, ab, bb, ob, beta,
                                    extra_mn_inputs, density)
    flops = int(2 * m * n * k * density)
    grid = (math.ceil(m / bm), math.ceil(n / bn), math.ceil(k / bk))
    auto_notes = [notes] if notes else []
    if density < 1.0:
        auto_notes.append(f"density={density:.2f}")
    if m % bm or n % bn:
        auto_notes.append("edge-mn")
    k_rem = k % bk
    if k_rem:
        auto_notes.append("edge-k(predicated)")
    return GemmPlan(
        m=m, n=n, k=k, bm=bm, bn=bn, bk=bk,
        a_dtype=a_dtype, b_dtype=b_dtype,
        out_dtype=out_dtype, acc_dtype=acc_dtype,
        grid=grid, vmem_bytes=ws, hbm_bytes=traffic, flops=flops,
        cmr=flops / max(1, traffic), k_rem=k_rem,
        notes=" ".join(auto_notes), design=design, stages=stages,
        splits=splits, per=per,
    )


def grouped_plan_from_2d(plan: GemmPlan, g: int) -> GemmPlan:
    """Lift a 2-D plan to a G-group batched one, as the reference does:
    per-group traffic and FLOPs scale by G (CMR is invariant), blocks and
    shared memory are unchanged.  The split stays the plan's: a split for
    G groups comes from solving with ``g`` (:func:`plan_grouped_gemm`,
    ``plan_with_blocks(g=)``)."""
    if g < 1:
        raise ValueError(f"group count must be >= 1, got {g}")
    if g == 1:
        return plan
    notes = " ".join(x for x in (plan.notes, f"grouped(g={g})") if x)
    return dataclasses.replace(
        plan, g=g, flops=plan.flops * g, hbm_bytes=plan.hbm_bytes * g,
        notes=notes,
    )


def plan_grouped_gemm(
    g: int,
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    acc_dtype=None,
    *,
    beta: float = 0.0,
    hw: HardwareSpec = DEFAULT_HW,
    vmem_budget_frac: float = 1.0,
    max_block: int = 2048,
    **kw,
) -> GemmPlan:
    """Block plan for a grouped GEMM: G independent M x N x K problems in
    one launch.  The blocks are the 2-D solve's; the split is solved for
    the G groups' tiles (they share the SMs)."""
    return plan_gemm(m, n, k, a_dtype, b_dtype, out_dtype, acc_dtype,
                     beta=beta, hw=hw, vmem_budget_frac=vmem_budget_frac,
                     max_block=max_block, g=g, **kw)


# --- the kernel's limits -----------------------------------------------------

def plan_limits(plan: GemmPlan, *, design: str, m: int, n: int, k: int,
                g: int = 1, a_dtype="float32", b_dtype=None,
                trans_a: bool = False, trans_b: bool = False,
                layout: str = "", blocks: Optional[Tuple[int, int]] = None,
                max_count: Optional[int] = None,
                sms: int = H100_SMS) -> Optional[str]:
    """Why the kernel cannot run ``plan`` for this launch, or None.

    The launch's design, shape and groups; the ring's stages as the kernel
    sizes them; wgmma and tf32x3: bm 64 or 128, bn 128, bk one TMA row
    (K2, K3: the payload's ``blocks`` = (bk, bn)); fma: a tile of
    :data:`FMA_TILES` with its own depth; the split: ``splits`` slices of
    ``per`` that leave none empty, at most 65,535 slices of all groups in
    the grid, tf32x3 in whole 128-deep folds, one slice for fma and simt,
    and within one wave of ``sms`` blocks for tf32x3, K2 and K3 (a block
    of theirs holds an SM).  ``kernels/mpgemm.py`` raises on a tuned or
    given plan outside them: nothing clamps it or falls back."""
    a, b, _, _ = _resolve_dtypes(a_dtype, b_dtype)
    if plan.design != design:
        return f"design {plan.design!r}, the launch runs {design!r}"
    if (plan.m, plan.n, plan.k, plan.g) != (m, n, k, g):
        return (f"shape {plan.g}x{plan.m}x{plan.n}x{plan.k}, the launch is "
                f"{g}x{m}x{n}x{k}")
    if design == "fma" and (plan.bm, plan.bn) not in FMA_TILES:
        return f"fma tile ({plan.bm}, {plan.bn}) not in {list(FMA_TILES)}"
    if design in ("wgmma", "tf32x3"):
        if plan.bm not in (WGMMA_M, 2 * WGMMA_M):
            return f"bm {plan.bm}: the wgmma designs take 64 or 128"
        want = (tuple(blocks) if layout else (k1_wgmma_bk(a), WGMMA_BN))
        if (plan.bk, plan.bn) != want:
            return f"(bk, bn) ({plan.bk}, {plan.bn}), the kernel's {want}"
    if design == "fma" and plan.bk != FMA_TILES[(plan.bm, plan.bn)][2]:
        return f"fma bk {plan.bk}, the tile's {FMA_TILES[(plan.bm, plan.bn)][2]}"
    stages = _design_stages(design, plan.bm, plan.bn, a, b, trans_a,
                            trans_b, layout)
    if plan.stages != stages:
        return f"stages {plan.stages}, the kernel's ring has {stages}"
    splits, per = plan.splits, plan.per
    total = _split_total(design, k, plan.bk, layout, max_count)
    if splits < 1 or per < 1:
        return f"split {splits} x {per}"
    if (splits - 1) * per >= total or splits * per < total:
        return (f"split {splits} x {per} over {total} tiles leaves a slice "
                "empty or a tile out")
    if design in ("fma", "simt") and splits != 1:
        return f"the {design} design takes no split ({splits} slices)"
    if g * splits > 65535:
        return f"{g} groups x {splits} slices pass the grid's 65,535"
    if design == "tf32x3" and per % (128 // plan.bk):
        return f"tf32x3 slices of {per} stages cut a 128-deep fold"
    tiles = g * _cdiv(m, plan.bm) * _cdiv(n, plan.bn)
    if (splits > 1 and tiles * splits > sms
            and (design == "tf32x3" or (design == "wgmma" and layout))):
        return (f"{tiles} tiles x {splits} slices pass one wave of {sms} "
                "blocks")
    return None


def check_plan(plan: GemmPlan, **launch) -> GemmPlan:
    """``plan``, or ValueError when it is outside the kernel's limits
    (:func:`plan_limits`)."""
    why = plan_limits(plan, **launch)
    if why is not None:
        raise ValueError(f"{plan.describe()} is outside the kernel's "
                         f"limits: {why}")
    return plan


# --- the wire format ---------------------------------------------------------

def plan_to_dict(plan: GemmPlan) -> dict:
    """JSON-safe dict form of a plan (tuning/plan_cache.py wire format):
    the reference's keys, then ``design``, ``stages``, ``splits``,
    ``per``."""
    d = dataclasses.asdict(plan)
    d["grid"] = list(plan.grid)
    return d


def plan_from_dict(d: dict) -> GemmPlan:
    """Inverse of :func:`plan_to_dict`; also reads a dict written by the
    reference, whose missing Hopper keys take their defaults (``per``:
    every K tile in one slice)."""
    d = dict(d)
    d["grid"] = tuple(d["grid"])
    d.setdefault("per", d["grid"][2])
    return GemmPlan(**d)


def naive_plan(m: int, n: int, k: int, a_dtype="float32", **kw) -> GemmPlan:
    """The 'fixed tile' baseline the paper ablates against, on Hopper: the
    wgmma design's largest block (128 x 128) and no split, whatever the
    shape (the reference's is a fixed 256^3 block on the TPU)."""
    plan = plan_gemm(m, n, k, a_dtype, **kw)
    if plan.design not in ("wgmma", "tf32x3"):
        return plan
    kw = {x: kw[x] for x in ("hw", "trans_a", "trans_b", "layout", "beta",
                             "extra_mn_inputs", "density", "max_count")
          if x in kw}
    total = _split_total(plan.design, k, plan.bk, kw.get("layout", ""),
                         kw.get("max_count"))
    naive = plan_with_blocks(m, n, k, 2 * WGMMA_M, plan.bn, plan.bk,
                             plan.a_dtype, plan.b_dtype, plan.out_dtype,
                             plan.acc_dtype, design=plan.design, splits=1,
                             per=total, notes="naive-128x128", **kw)
    return grouped_plan_from_2d(naive, plan.g)
