"""Characterization report -- the analytic plan against the measured
sweep, side by side (port of ``repro.tuning.report``).

One markdown row per tuned shape: the open-loop analytic plan against the
sweep's winner on modeled traffic, CMR (the paper's eq (3) objective) and
time, each block shown with its split over K (``s<slices>x<per>``).  With
``mode`` ``cuda`` the times are CUDA-event times on the card; with
``modeled`` they are roofline predictions on the H100 spec, never a
measurement.
"""
from __future__ import annotations

from typing import Iterable, List

from repro_torch.tuning.microbench import Measurement, TuneResult

_HEADER = (
    "| workload (M×N×K, dtype) | analytic blocks | tuned blocks | "
    "traffic MiB (analytic→tuned) | CMR (analytic→tuned) | "
    "wall µs (analytic→tuned) | speedup | mode |"
)
_RULE = "|---|---|---|---|---|---|---|---|"


def _fmt_blocks(m: Measurement) -> str:
    return ("×".join(str(b) for b in m.blocks)
            + f" s{m.plan.splits}x{m.plan.per}")


def _row(r: TuneResult) -> str:
    ap, bp = r.analytic.plan, r.best.plan
    workload = f"{ap.m}×{ap.n}×{ap.k}, {ap.a_dtype}"
    if ap.g != 1:
        workload = f"{ap.g}×" + workload
    tuned = _fmt_blocks(r.best) + ("" if r.tuned_differs else " (=analytic)")
    return (
        f"| {workload} | {_fmt_blocks(r.analytic)} | {tuned} "
        f"| {ap.hbm_bytes / 2**20:.1f} → {bp.hbm_bytes / 2**20:.1f} "
        f"| {ap.cmr:.1f} → {bp.cmr:.1f} "
        f"| {r.analytic.wall_us:.1f} → {r.best.wall_us:.1f} "
        f"| {r.speedup:.2f}× | {r.best.mode} |"
    )


def characterization_report(results: Iterable[TuneResult]) -> str:
    """Markdown report for a batch of :func:`~repro_torch.tuning.tune_gemm`
    runs.

    Example (runnable on the CPU)::

        >>> from repro_torch.tuning import PlanCache, tune_gemm
        >>> from repro_torch.tuning.report import characterization_report
        >>> r = tune_gemm(128, 128, 256, "bfloat16", mode="modeled",
        ...               cache=PlanCache(None))
        >>> print(characterization_report([r]))  # doctest: +ELLIPSIS
        # MPGEMM autotuning characterization...
    """
    results = list(results)
    lines: List[str] = [
        "# MPGEMM autotuning characterization",
        "",
        "Analytic plan = open-loop optimum of the eq (1)-(3) model "
        "(core/blocking.py), equal to the design rules.  Tuned plan = "
        "measured winner of the bounded sweep around it "
        "(tuning/microbench.py).",
        "",
        _HEADER,
        _RULE,
    ]
    lines += [_row(r) for r in results]
    tuned = sum(1 for r in results if r.tuned_differs)
    if results:
        geo = 1.0
        for r in results:
            geo *= r.speedup
        geo **= 1.0 / len(results)
        lines += [
            "",
            f"Tuning moved the plan on {tuned}/{len(results)} workloads; "
            f"geomean measured speedup {geo:.3f}× "
            "(≥ 1.0 by construction: the analytic plan is always in the "
            "sweep).",
        ]
    return "\n".join(lines)


def write_report(results: Iterable[TuneResult], path) -> str:
    """Render and write the report; returns the markdown string."""
    md = characterization_report(results)
    with open(path, "w") as f:
        f.write(md + "\n")
    return md
