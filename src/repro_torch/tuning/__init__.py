"""Empirical characterization and plan tuning on the card (port of
``repro.tuning``, the paper's Section III).

Closes the planning loop around the analytic model in
``core/blocking.py``:

    plan_gemm (analytic seed: the design rules)
        └─ tune_gemm: sweep plans around the seed on the card, measure,
           store the winner in a PlanCache (REPRO_TORCH_PLAN_CACHE)
               └─ mpgemm / mpgemm_grouped: every K1, K2 and K3 launch
                  reads the tuned plan, the analytic one on a miss.

Public API: :func:`tune_gemm`, :func:`tune_grouped_gemm`,
:func:`tune_sparse_gemm`, :func:`sweep`, :func:`sweep_axis`,
:class:`PlanCache`, :func:`get_plan_cache`, :func:`set_plan_cache`,
:func:`lookup_plan`, :func:`make_key`, :func:`lookup_counts`,
:func:`~repro_torch.tuning.report.characterization_report`.
"""
from repro_torch.tuning.microbench import (
    Measurement, TuneResult, candidate_plans, measure_grouped_plan,
    measure_plan, sweep, sweep_axis, tune_gemm, tune_grouped_gemm,
    tune_sparse_gemm,
)
from repro_torch.tuning.plan_cache import (
    PlanCache, get_plan_cache, key_namespace, lookup_counts, lookup_plan,
    make_key, note_analytic_fallback, reset_lookup_counts, reset_plan_cache,
    set_plan_cache,
)
from repro_torch.tuning.report import characterization_report, write_report

__all__ = [
    "Measurement", "TuneResult", "candidate_plans", "measure_grouped_plan",
    "measure_plan", "sweep", "sweep_axis", "tune_gemm", "tune_grouped_gemm",
    "tune_sparse_gemm",
    "PlanCache", "get_plan_cache", "key_namespace", "lookup_counts",
    "lookup_plan", "make_key", "note_analytic_fallback",
    "reset_lookup_counts", "reset_plan_cache", "set_plan_cache",
    "characterization_report", "write_report",
]
