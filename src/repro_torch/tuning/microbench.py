"""Empirical characterization of K1, K2 and K3 on the card -- the paper's
Section III, measure first, then model (port of
``repro.tuning.microbench``).

* :func:`sweep` times ``kernels/mpgemm.py::mpgemm`` over a bounded set of
  plans seeded by the analytic one (:func:`candidate_plans`): the wgmma
  lattice's tile rows (64, 128) and, for each, a ladder of splits over K
  around the design rule's -- or, for the ``fma`` design, its tiles.
* :func:`sweep_axis` is the 1-D form (vary bm, or the split, with the
  rest pinned).
* :func:`tune_gemm` runs a sweep, picks the winner and stores it in a
  :class:`~repro_torch.tuning.plan_cache.PlanCache`, so that every later
  launch of the same GEMM instance takes it.

Every candidate is a plan the kernel takes (``core/blocking.py::
plan_limits``): bm 64 or 128, splits that leave no slice empty, and one
wave of SMs for K2, K3 and tf32x3.  A tuned plan may sum K in another order
than the analytic one, so it may change bits: tuned plans come only from a
cache that a tuning run wrote.

Measurement modes
-----------------
``cuda``      the launch on the card, timed with CUDA events (best of
              ``iters`` after ``warmup``, each on a cold L2).
``modeled``   no launch: each plan is priced by its roofline time on the
              H100 spec (its modeled traffic over the memory rate, its
              operations over the peak of its design).  The only mode on
              the CPU.  Its winner is keyed under the spec's name with
              ``-modeled`` appended (``h100_132sm-modeled``), which no
              launch reads: a launch's tuned plan comes only from a
              measurement.
``auto``      ``cuda``; raises where no card is visible (ask for
              ``modeled`` by name).

The reference's TPU modes (``compiled``, ``interpret``) are not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.blocking import (
    FMA_TILES, GemmPlan, _cdiv, _split_total, default_design,
    enumerate_block_lattice, grouped_plan_from_2d, plan_gemm, plan_limits,
    plan_with_blocks,
)
from repro_torch.core.constants import DEFAULT_HW, HardwareSpec
from repro_torch.core.gemm_spec import EpilogueSpec, get_epilogue
from repro_torch.tuning.plan_cache import PlanCache, get_plan_cache, make_key

MODES = ("auto", "cuda", "modeled")

# The slice counts a sweep tries around the rule's (each rounded to the
# count that leaves no slice empty).
_SPLIT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


@dataclasses.dataclass(frozen=True)
class Measurement:
    """One candidate: the plan tried and what it cost."""

    plan: GemmPlan
    mode: str            # how wall_us was obtained (cuda / modeled)
    wall_us: float       # measured time (== modeled_us in modeled mode)
    modeled_us: float    # roofline prediction from the plan's model

    @property
    def blocks(self) -> Tuple[int, int, int]:
        return (self.plan.bm, self.plan.bn, self.plan.bk)

    @property
    def split(self) -> Tuple[int, int]:
        return (self.plan.splits, self.plan.per)


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of :func:`tune_gemm` for one GEMM instance."""

    key: str
    analytic: Measurement          # the planner's open-loop choice
    best: Measurement              # the sweep winner (may equal analytic)
    measurements: Tuple[Measurement, ...]

    @property
    def speedup(self) -> float:
        """Measured analytic time / best time (>= 1.0 by construction)."""
        return self.analytic.wall_us / max(self.best.wall_us, 1e-9)

    @property
    def tuned_differs(self) -> bool:
        return (self.best.blocks, self.best.split) != (
            self.analytic.blocks, self.analytic.split)


def _resolve_mode(mode: str) -> str:
    import torch
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; valid: {MODES}")
    if mode in ("auto", "cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"mode {mode!r} needs a CUDA device (mode "
                           f"'modeled' prices plans without one)")
    return "cuda" if mode == "auto" else mode


def _resolve_hw(hw: Optional[HardwareSpec], mode: str) -> HardwareSpec:
    """The spec plans are made and keyed for: the card's in cuda mode (the
    launches key with it), else the H100 SXM5 default."""
    if hw is not None:
        return hw
    if mode == "cuda":
        import torch
        from repro_torch.core.constants import device_spec
        return device_spec(torch.cuda.current_device())
    return DEFAULT_HW


def _key_hw(hw: HardwareSpec, mode: str) -> HardwareSpec:
    """The spec a tuned plan is keyed under: ``hw`` for a measured plan,
    which the launches on that card read; ``hw`` named ``<name>-modeled``
    for a priced one, which no launch reads."""
    if mode == "cuda":
        return hw
    return dataclasses.replace(hw, name=f"{hw.name}-modeled")


def _modeled_us(plan: GemmPlan, hw: HardwareSpec) -> float:
    if plan.a_dtype == "int8":
        peak = hw.peak_ops_int8
    elif plan.a_dtype in ("bfloat16", "float16"):
        peak = hw.peak_flops_bf16
    elif plan.design == "tf32x3":
        peak = hw.peak_flops_tf32
    else:
        peak = hw.peak_flops_fp32
    return max(plan.flops / peak, plan.hbm_bytes / hw.hbm_bw) * 1e6


def _operands(m: int, n: int, k: int, a_dtype, b_dtype, trans_a: bool,
              trans_b: bool, seed: int = 0, g: Optional[int] = None):
    """Random operands on the card for one (optionally grouped) GEMM, drawn
    there from ``seed`` (an expert stack is gigabytes: no host copy)."""
    import torch
    from repro_torch.core.codecs import torch_dtype
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if g is None else (g,)

    def _mk(shape, dtype):
        dt = torch_dtype(dtype)
        if dt == torch.int8:
            return torch.randint(-127, 127, shape, generator=gen,
                                 device="cuda", dtype=dt)
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    a = _mk(lead + ((k, m) if trans_a else (m, k)), a_dtype)
    b = _mk(lead + ((n, k) if trans_b else (k, n)), b_dtype or a_dtype)
    return a, b


def _epilogue_kwargs(epilogue: Optional[EpilogueSpec], m: int, n: int,
                     plan: GemmPlan, seed: int = 0,
                     g: Optional[int] = None) -> dict:
    """Launch kwargs and operands so that a sweep times the epilogue it
    will serve: a fusion streams extra (M, N) operands (a row scale (M,
    1)), beta a C.  {} for the default linear epilogue."""
    if epilogue is None:
        return {}
    import torch
    from repro_torch.core.codecs import torch_dtype
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    lead = () if g is None else (g,)
    out = torch_dtype(plan.out_dtype)

    def _mn(rows_only=False):
        shape = lead + (m, 1 if rows_only else n)
        x = torch.randn(shape, generator=gen, device="cuda")
        return x.to(torch.float32 if rows_only else out)

    ed = get_epilogue(epilogue.kind)
    kw = {"epilogue": epilogue,
          "extras": tuple(_mn(x in ed.row_operands)
                          for x in ed.extra_operands)}
    if epilogue.beta != 0.0:
        kw["c"] = _mn()
    return kw


# A launch is timed on a cold L2, as a decode step finds its weights: a
# buffer of 256 MiB (5x the H100's 50 MB L2) is zeroed before it, then the
# card spins about 0.5 ms, so that the host's work in the wrapper runs
# while the card is busy and the events time the launch alone.
_FLUSH_BYTES = 256 << 20
_SPIN_CYCLES = 1_000_000


def _time_best(run, iters: int, warmup: int) -> float:
    """Best-of-``iters`` microseconds of ``run()`` on the card, each launch
    on a cold L2 between two CUDA events, after ``warmup`` launches."""
    import torch
    flush = torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best * 1e3


def _launch_fn(a, b, plan: GemmPlan, trans_a: bool, trans_b: bool,
               f32_fma: bool, epilogue_kwargs: Optional[dict]):
    from repro_torch.core.codecs import torch_dtype
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped
    grouped = plan.g != 1 or a.dim() == 3
    spec = GemmSpec(grouped=grouped, trans_a=trans_a, trans_b=trans_b)
    fn = mpgemm_grouped if grouped else mpgemm
    kw = dict(epilogue_kwargs or {})

    def run():
        return fn(a, b, spec=spec, out_dtype=torch_dtype(plan.out_dtype),
                  plan=plan, f32_fma=f32_fma, **kw)
    return run


def measure_plan(
    a,
    b,
    plan: GemmPlan,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    mode: str = "auto",
    iters: int = 5,
    warmup: int = 2,
    hw: Optional[HardwareSpec] = None,
    epilogue_kwargs: Optional[dict] = None,
    f32_fma: bool = False,
) -> Measurement:
    """Time ``mpgemm`` (``mpgemm_grouped`` for a grouped plan or operands,
    ``a`` may be a packed or sparse B's partner) under one forced plan."""
    mode = _resolve_mode(mode)
    modeled = _modeled_us(plan, _resolve_hw(hw, mode))
    if mode == "modeled":
        return Measurement(plan=plan, mode=mode, wall_us=modeled,
                           modeled_us=modeled)
    run = _launch_fn(a, b, plan, trans_a, trans_b, f32_fma, epilogue_kwargs)
    return Measurement(plan=plan, mode=mode,
                       wall_us=_time_best(run, iters, warmup),
                       modeled_us=modeled)


measure_grouped_plan = measure_plan


def _split_ladder(total: int, design: str, bk: int, seed: int,
                  radius: int) -> List[Tuple[int, int]]:
    """(splits, per) pairs around the rule's ``seed`` slices: the ladder's
    counts, each rounded to the count that leaves no slice empty (tf32x3:
    slices of whole 128-deep folds), ``2 * radius`` ladder steps either
    side of the seed."""
    unit = 128 // bk if design == "tf32x3" else 1
    pairs = {}
    for s in sorted(set(_SPLIT_LADDER) | {seed}):
        per = _cdiv(_cdiv(total, s), unit) * unit
        pairs.setdefault(_cdiv(total, per), per)
    counts = sorted(pairs)
    i = counts.index(min(counts, key=lambda c: abs(c - seed)))
    lo, hi = max(0, i - 2 * radius), i + 2 * radius + 1
    return [(c, pairs[c]) for c in counts[lo:hi]]


def candidate_plans(
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    *,
    beta: float = 0.0,
    extra_mn_inputs: int = 0,
    hw: HardwareSpec = DEFAULT_HW,
    radius: int = 1,
    max_candidates: int = 24,
    vmem_budget_frac: float = 1.0,
    g: int = 1,
    design: Optional[str] = None,
    trans_a: bool = False,
    trans_b: bool = False,
    layout: str = "",
    blocks: Optional[Tuple[int, int]] = None,
    max_count: Optional[int] = None,
    density: float = 1.0,
) -> List[GemmPlan]:
    """The bounded sweep: the analytic plan first, then every plan of the
    lattice's tile rows within ``radius`` steps of its own, each with the
    splits :func:`_split_ladder` gives (wgmma, tf32x3), or the ``fma``
    design's tiles; a packed or sparse B's (bk, bn) is its ``blocks``.
    Only plans inside the kernel's limits (``plan_limits``) and within
    ``vmem_budget_frac`` of a block's shared memory are kept, nearest to
    the seed first, at most ``max_candidates``.  The analytic plan is
    always candidate 0, so ``tune_gemm``'s speedup is >= 1 by
    construction.  ``g`` > 1 gives grouped plans (their split solved for
    the G groups)."""
    design = design or default_design(a_dtype, b_dtype, layout=layout)
    common = dict(beta=beta, extra_mn_inputs=extra_mn_inputs, hw=hw,
                  design=design, trans_a=trans_a, trans_b=trans_b,
                  layout=layout, max_count=max_count, density=density)
    seed = plan_gemm(m, n, k, a_dtype, b_dtype, out_dtype, g=g,
                     vmem_budget_frac=vmem_budget_frac, blocks=blocks,
                     **common)
    bn, bk = seed.bn, seed.bk
    limits = dict(design=design, m=m, n=n, k=k, g=g, a_dtype=a_dtype,
                  b_dtype=b_dtype, trans_a=trans_a, trans_b=trans_b,
                  layout=layout, blocks=blocks, max_count=max_count,
                  sms=hw.sms)
    cands: List[GemmPlan] = []
    if design == "fma":
        for tbm, tbn in FMA_TILES:
            cands.append(plan_with_blocks(
                m, n, k, tbm, tbn, FMA_TILES[(tbm, tbn)][2], a_dtype,
                b_dtype, out_dtype, g=g, notes="tuned", **common))
    elif design in ("wgmma", "tf32x3"):
        axis = enumerate_block_lattice(m, n, k, a_dtype, b_dtype, hw=hw,
                                       design=design, layout=layout)[0]
        i = axis.index(seed.bm) if seed.bm in axis else 0
        total = _split_total(design, k, bk, layout, max_count)
        for bm in axis[max(0, i - radius):i + radius + 1]:
            for splits, per in _split_ladder(total, design, bk, seed.splits,
                                             radius):
                cands.append(plan_with_blocks(
                    m, n, k, bm, bn, bk, a_dtype, b_dtype, out_dtype, g=g,
                    splits=splits, per=per, notes="tuned", **common))
    budget = int(hw.smem_bytes * vmem_budget_frac)
    plans = [seed]
    seen = {(seed.bm, seed.bn, seed.bk, seed.split)}
    for cand in (grouped_plan_from_2d(c, g) for c in cands):
        ident = (cand.bm, cand.bn, cand.bk, cand.split)
        if (ident in seen or cand.vmem_bytes > budget
                or plan_limits(cand, **limits) is not None):
            continue
        seen.add(ident)
        plans.append(cand)

    def distance(p):
        return (abs(p.bm - seed.bm) / 64 + abs(p.bn - seed.bn) / 64
                + abs(math.log2(p.splits / seed.splits)))
    plans[1:] = sorted(plans[1:], key=distance)
    return plans[:max_candidates]


def _design_of(a, b, a_dtype, b_dtype, f32_fma, layout="") -> str:
    """The design a sweep's launches run: the kernel layer's rule on the
    operands made for it, or the aligned default in modeled mode."""
    if a is None:
        return default_design(a_dtype, b_dtype, layout=layout,
                              f32_fma=f32_fma)
    from repro_torch.kernels import mpgemm as K
    if layout == "sparse":
        return K.k3_design(a, b)
    if layout == "packed":
        return K.k2_design(a, b)
    return K.k1_design(a, b, f32_fma)


def sweep(
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    beta: float = 0.0,
    epilogue: Optional[EpilogueSpec] = None,
    mode: str = "auto",
    radius: int = 1,
    max_candidates: int = 24,
    iters: int = 5,
    warmup: int = 2,
    hw: Optional[HardwareSpec] = None,
    seed: int = 0,
    g: int = 1,
    f32_fma: bool = False,
) -> List[Measurement]:
    """Measure every candidate plan for one GEMM instance (``g`` groups of
    it), launching the epilogue it will serve."""
    mode = _resolve_mode(mode)
    hw = _resolve_hw(hw, mode)
    n_extra = 0
    if epilogue is not None:
        ed = get_epilogue(epilogue.kind)
        n_extra = sum(1 for x in ed.extra_operands
                      if x not in ed.row_operands)
        beta = epilogue.beta
    a = b = None
    if mode == "cuda":
        a, b = _operands(m, n, k, a_dtype, b_dtype, trans_a, trans_b, seed,
                         g=None if g == 1 else g)
    design = _design_of(a, b, a_dtype, b_dtype, f32_fma)
    plans = candidate_plans(
        m, n, k, a_dtype, b_dtype, out_dtype, beta=beta,
        extra_mn_inputs=n_extra, hw=hw, radius=radius,
        max_candidates=max_candidates, g=g, design=design, trans_a=trans_a,
        trans_b=trans_b)
    if mode == "modeled":
        return [measure_plan(None, None, p, mode="modeled", hw=hw)
                for p in plans]
    ep_kw = _epilogue_kwargs(epilogue, m, n, plans[0], seed,
                             g=None if g == 1 else g)
    return [measure_plan(a, b, p, trans_a=trans_a, trans_b=trans_b,
                         mode=mode, iters=iters, warmup=warmup, hw=hw,
                         epilogue_kwargs=ep_kw, f32_fma=f32_fma)
            for p in plans]


def sweep_axis(
    m: int,
    n: int,
    k: int,
    axis: str,
    a_dtype="float32",
    *,
    mode: str = "auto",
    hw: Optional[HardwareSpec] = None,
    vmem_budget_frac: float = 1.0,
    iters: int = 5,
    warmup: int = 2,
    seed: int = 0,
) -> List[Measurement]:
    """1-D characterization sweep: vary one axis of the plan, the rest
    pinned to the analytic plan's.  ``bm`` is the tile-count sweep (one or
    two warpgroups), ``splits`` the split over K (the slices the SMs
    share); ``bn`` and ``bk`` have one point each on Hopper (wgmma's 128
    columns, one TMA row of K)."""
    if axis not in ("bm", "bn", "bk", "splits"):
        raise ValueError(f"axis must be bm|bn|bk|splits, got {axis!r}")
    mode = _resolve_mode(mode)
    hw = _resolve_hw(hw, mode)
    seed_plan = plan_gemm(m, n, k, a_dtype, hw=hw,
                          vmem_budget_frac=vmem_budget_frac)
    if axis == "splits":
        plans = [p for p in candidate_plans(
            m, n, k, a_dtype, hw=hw, radius=8, max_candidates=256,
            vmem_budget_frac=vmem_budget_frac) if p.bm == seed_plan.bm]
        plans.sort(key=lambda p: p.splits)
    elif axis == "bm":
        bms = enumerate_block_lattice(m, n, k, a_dtype, hw=hw)[0]
        plans = [plan_with_blocks(m, n, k, bm, seed_plan.bn, seed_plan.bk,
                                  a_dtype, hw=hw, notes="sweep")
                 for bm in bms]
    else:
        plans = [seed_plan]
    a = b = None
    if mode == "cuda":
        a, b = _operands(m, n, k, a_dtype, None, False, False, seed)
    return [measure_plan(a, b, p, mode=mode, hw=hw, iters=iters,
                         warmup=warmup) for p in plans]


def _persist_best(key: str, measurements: Sequence[Measurement],
                  cache: Optional[PlanCache], save: bool,
                  extra_meta: Optional[dict] = None) -> TuneResult:
    """Shared tune-result tail: pick the winner, write it to the cache.
    ``measurements[0]`` is the analytic seed, so the speedup is >= 1."""
    analytic = measurements[0]
    best = min(measurements, key=lambda mm: mm.wall_us)
    if cache is None:
        cache = get_plan_cache()
    if cache is not None:
        meta = {
            "mode": best.mode,
            "wall_us": best.wall_us,
            "modeled_us": best.modeled_us,
            "analytic_wall_us": analytic.wall_us,
            "analytic_blocks": list(analytic.blocks),
            "analytic_split": list(analytic.split),
            "candidates": len(measurements),
        }
        meta.update(extra_meta or {})
        cache.put(key, best.plan, meta=meta)
        if save:
            cache.save()
    return TuneResult(key=key, analytic=analytic, best=best,
                      measurements=tuple(measurements))


def tune_gemm(
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    beta: float = 0.0,
    epilogue: Optional[EpilogueSpec] = None,
    mode: str = "auto",
    radius: int = 1,
    max_candidates: int = 24,
    iters: int = 5,
    warmup: int = 2,
    hw: Optional[HardwareSpec] = None,
    cache: Optional[PlanCache] = None,
    save: bool = True,
    seed: int = 0,
    f32_fma: bool = False,
) -> TuneResult:
    """Sweep, pick the measured winner, store it in the plan cache.

    ``cache=None`` uses the process-global cache
    (``REPRO_TORCH_PLAN_CACHE``: a JSON path persists it), so the next
    ``mpgemm`` of this instance on the card takes the tuned plan.  Launches
    resolve their plan when they run: a CUDA graph captured before the
    tuning keeps the plans it was captured with (its kernels' arguments are
    fixed in the graph) until it is captured again.  ``hw`` defaults to the
    card's spec in cuda mode (the key the launches read) and to the SXM5
    default in modeled mode, whose winner is keyed ``<hw>-modeled``.  ``epilogue`` tunes that fused spec under its
    own key; ``f32_fma`` tunes the fp32 policy's ``fma`` design (key tag
    ``design=fma``).  ``save=True`` also flushes an on-disk cache.

    Runnable on the CPU::

        >>> from repro_torch.tuning import PlanCache, tune_gemm
        >>> cache = PlanCache(None)            # in-memory
        >>> r = tune_gemm(128, 128, 256, "bfloat16", mode="modeled",
        ...               cache=cache)
        >>> r.speedup >= 1.0 and len(cache) == 1
        True
    """
    mode = _resolve_mode(mode)
    hw = _resolve_hw(hw, mode)
    measurements = sweep(
        m, n, k, a_dtype, b_dtype, out_dtype,
        trans_a=trans_a, trans_b=trans_b, beta=beta, epilogue=epilogue,
        mode=mode, radius=radius, max_candidates=max_candidates,
        iters=iters, warmup=warmup, hw=hw, seed=seed, f32_fma=f32_fma,
    )
    if epilogue is not None and epilogue.beta != 0.0:
        beta = epilogue.beta
    key = make_key(m, n, k, a_dtype, b_dtype, out_dtype,
                   trans_a=trans_a, trans_b=trans_b, beta=beta,
                   hw=_key_hw(hw, mode),
                   epilogue=epilogue.tag if epilogue is not None else "",
                   design="fma" if measurements[0].plan.design == "fma"
                   else "")
    return _persist_best(key, measurements, cache, save)


def tune_sparse_gemm(
    m: int,
    a,
    b_sparse,
    *,
    out_dtype=None,
    trans_a: bool = False,
    epilogue: Optional[EpilogueSpec] = None,
    mode: str = "auto",
    radius: int = 1,
    iters: int = 5,
    warmup: int = 2,
    hw: Optional[HardwareSpec] = None,
    cache: Optional[PlanCache] = None,
    save: bool = True,
    seed: int = 0,
) -> TuneResult:
    """:func:`tune_gemm` for a tile-sparse B (``repro_torch.sparse``):
    its stored-tile layout pins (bn, bk), so the sweep walks the tile rows
    and the split of a column's stored tiles (around ``k3_split``'s),
    timing the launch ``mpgemm(a, b_sparse)`` (``mpgemm_grouped`` for a
    grouped operand) on the card, or pricing each plan by its
    density-scaled roofline in modeled mode (``a`` may then be None).  The
    winner is stored under the key the launch reads back:
    ``make_key(..., g=layout.g, epilogue=tag, sparsity=layout.tag)``."""
    layout = b_sparse.layout
    n, k, g = layout.n, layout.k, layout.g
    mode = _resolve_mode(mode)
    hw = _resolve_hw(hw, mode)
    a_dtype = a.dtype if a is not None else layout.dtype
    n_extra, ep_beta = 0, 0.0
    if epilogue is not None:
        ed = get_epilogue(epilogue.kind)
        n_extra = sum(1 for x in ed.extra_operands
                      if x not in ed.row_operands)
        ep_beta = epilogue.beta
    a_k = a
    if a is not None and trans_a:
        a_k = a.transpose(-1, -2).contiguous()
    design = _design_of(a_k, b_sparse, a_dtype, layout.dtype, False,
                        layout="sparse")
    acc = "float32" if layout.per_tile_scales else None
    plans = candidate_plans(
        m, n, k, a_dtype, layout.dtype, out_dtype, beta=ep_beta,
        extra_mn_inputs=n_extra, hw=hw, radius=radius, g=g, design=design,
        layout="sparse", blocks=(layout.bk, layout.bn),
        max_count=layout.max_column_tiles, density=layout.density)
    if acc is not None:
        plans = [dataclasses.replace(p, acc_dtype=acc) for p in plans]
    if mode == "modeled":
        measurements = [measure_plan(None, None, p, mode="modeled", hw=hw)
                        for p in plans]
    else:
        ep_kw = _epilogue_kwargs(epilogue, m, n, plans[0], seed,
                                 g=None if g == 1 else g)
        measurements = [measure_plan(a, b_sparse, p, trans_a=trans_a,
                                     mode=mode, iters=iters, warmup=warmup,
                                     hw=hw, epilogue_kwargs=ep_kw)
                        for p in plans]
    key = make_key(m, n, k, a_dtype, layout.dtype, out_dtype,
                   trans_a=trans_a, trans_b=False, beta=ep_beta,
                   hw=_key_hw(hw, mode), g=g, epilogue=epilogue.tag if epilogue is not None else "",
                   sparsity=layout.tag)
    return _persist_best(key, measurements, cache, save,
                         extra_meta={"sparsity": layout.tag,
                                     "density": layout.density, "g": g})


def tune_grouped_gemm(
    g: int,
    m: int,
    n: int,
    k: int,
    a_dtype="float32",
    b_dtype=None,
    out_dtype=None,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    epilogue: Optional[EpilogueSpec] = None,
    mode: str = "auto",
    radius: int = 1,
    max_candidates: int = 24,
    iters: int = 5,
    warmup: int = 2,
    hw: Optional[HardwareSpec] = None,
    cache: Optional[PlanCache] = None,
    save: bool = True,
    seed: int = 0,
    f32_fma: bool = False,
) -> TuneResult:
    """:func:`tune_gemm` for a grouped instance (G x (M, N, K)): the same
    candidates with their split solved for the G groups' tiles, timed
    through ``mpgemm_grouped`` and stored under the grouped key (``g…``
    prefix, plus the epilogue tag) that the grouped launch reads back.

    Runnable on the CPU::

        >>> from repro_torch.tuning import PlanCache, tune_grouped_gemm
        >>> cache = PlanCache(None)
        >>> r = tune_grouped_gemm(4, 64, 64, 128, "bfloat16",
        ...                       mode="modeled", cache=cache)
        >>> r.best.plan.g
        4
    """
    mode = _resolve_mode(mode)
    hw = _resolve_hw(hw, mode)
    measurements = sweep(
        m, n, k, a_dtype, b_dtype, out_dtype, trans_a=trans_a,
        trans_b=trans_b, epilogue=epilogue, mode=mode, radius=radius,
        max_candidates=max_candidates, iters=iters, warmup=warmup, hw=hw,
        seed=seed, g=g, f32_fma=f32_fma)
    ep_beta = epilogue.beta if epilogue is not None else 0.0
    key = make_key(m, n, k, a_dtype, b_dtype, out_dtype,
                   trans_a=trans_a, trans_b=trans_b, beta=ep_beta,
                   hw=_key_hw(hw, mode), g=g, epilogue=epilogue.tag if epilogue is not None else "",
                   design="fma" if measurements[0].plan.design == "fma"
                   else "")
    return _persist_best(key, measurements, cache, save, extra_meta={"g": g})
