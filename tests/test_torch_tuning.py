"""The port's tuner (``repro_torch.tuning``) on the CPU, where only its
``"modeled"`` mode runs: a tune persists its winner, every candidate is a
plan the kernel takes (``core/blocking.py::plan_limits``), and the report
keeps the reference's header.  Timing on the card (``"cuda"`` mode) is
``chip_smoke.py``'s ``phase_plans``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.tuning import report as jreport  # noqa: E402
from repro_torch.core import blocking as tb  # noqa: E402
from repro_torch.core.constants import DEFAULT_HW  # noqa: E402
from repro_torch.core.gemm_spec import EpilogueSpec  # noqa: E402
from repro_torch.tuning import (  # noqa: E402
    PlanCache, candidate_plans, characterization_report, make_key, sweep,
    sweep_axis, tune_gemm, tune_grouped_gemm, tune_sparse_gemm,
)
from repro_torch.tuning import microbench as mb  # noqa: E402
from repro_torch.tuning import report  # noqa: E402


def _within_limits(plans, m, n, k, *, g=1, dtype="bfloat16", b_dtype=None,
                   layout="", blocks=None, max_count=None, trans_a=False,
                   trans_b=False):
    assert plans
    for p in plans:
        assert tb.plan_limits(p, design=p.design, m=m, n=n, k=k, g=g,
                              a_dtype=dtype, b_dtype=b_dtype,
                              trans_a=trans_a, trans_b=trans_b,
                              layout=layout, blocks=blocks,
                              max_count=max_count) is None, p.describe()
    assert len({(p.bm, p.bn, p.bk, p.split) for p in plans}) == len(plans)


@pytest.mark.parametrize("m,n,k,dtype,design,g,trans_a", [
    (32, 3072, 3072, "bfloat16", None, 1, False),     # phi3 at M = 32
    (1024, 1024, 512, "bfloat16", None, 1, True),     # granite's dW
    (2, 16384, 6144, "bfloat16", None, 8, False),     # mixtral's experts
    (200, 1024, 1024, "float32", "tf32x3", 1, False),
    (1024, 32, 512, "float32", "fma", 1, True),       # granite's router dW
    (2, 3072, 3072, "int8", None, 1, False),
])
def test_candidates_stay_inside_the_kernel_limits(m, n, k, dtype, design, g,
                                                  trans_a):
    plans = candidate_plans(m, n, k, dtype, g=g, design=design,
                            trans_a=trans_a, radius=2)
    assert plans[0] == tb.plan_gemm(m, n, k, dtype, g=g, design=design,
                                    trans_a=trans_a)
    _within_limits(plans, m, n, k, g=g, dtype=dtype, trans_a=trans_a)
    if design == "fma":
        assert {(p.bm, p.bn) for p in plans} == set(tb.FMA_TILES)
    else:
        assert len({p.split for p in plans}) > 1 or m * n >= 2 ** 24


def test_modeled_tune_persists_its_winner(tmp_path):
    path = tmp_path / "plans.json"
    cache = PlanCache(path)
    r = tune_gemm(32, 3072, 3072, "bfloat16", mode="modeled", cache=cache)
    assert r.speedup >= 1.0 and r.best.mode == "modeled"
    assert r.analytic.plan == tb.plan_gemm(32, 3072, 3072, "bfloat16")
    # A priced plan keys under the spec's "-modeled" name, which no
    # launch reads.
    modeled = dataclasses.replace(DEFAULT_HW, name="h100_132sm-modeled")
    assert r.key == make_key(32, 3072, 3072, "bfloat16", hw=modeled)
    assert PlanCache(path).get(r.key) == r.best.plan
    assert PlanCache(path).get_meta(r.key)["candidates"] == len(
        r.measurements)
    ep = EpilogueSpec(kind="gated", activation="silu")
    rf = tune_gemm(64, 256, 512, "float32", mode="modeled", cache=cache,
                   f32_fma=True, epilogue=ep, trans_a=True)
    assert rf.key.endswith("|ep=gated-silu|design=fma")
    assert rf.best.plan.design == "fma"
    rg = tune_grouped_gemm(4, 64, 256, 512, "bfloat16", mode="modeled",
                           cache=cache)
    assert rg.best.plan.g == 4 and rg.key.startswith("g4|")
    assert len(PlanCache(path)) == 3
    for mode in ("cuda", "auto"):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tune_gemm(32, 256, 256, "bfloat16", mode=mode, cache=cache)
    with pytest.raises(ValueError, match="unknown mode"):
        sweep(32, 256, 256, "bfloat16", mode="interpret")


def test_modeled_sparse_tune_pins_the_layout():
    from repro_torch.sparse import sparsify_magnitude
    w = torch.randn(1024, 512, generator=torch.Generator().manual_seed(0))
    sp = sparsify_magnitude(w, (128, 128), density=0.5, dtype="int8")
    cache = PlanCache(None)
    r = tune_sparse_gemm(2, None, sp, out_dtype="bfloat16", mode="modeled",
                         cache=cache)
    lay = sp.layout
    assert r.key.endswith(f"|sp={lay.tag}")
    assert r.analytic.plan.split == tb.k3_split(2, 512, lay.max_column_tiles)
    _within_limits([m.plan for m in r.measurements], 2, 512, 1024,
                   dtype="int8", b_dtype="int8", layout="sparse",
                   blocks=(128, 128), max_count=lay.max_column_tiles)
    assert {m.plan.acc_dtype for m in r.measurements} == {"float32"}


def test_sweep_axis_and_modeled_times():
    bms = sweep_axis(200, 4096, 4096, "bm", "bfloat16", mode="modeled")
    assert [m.plan.bm for m in bms] == [64, 128]
    assert bms[1].wall_us < bms[0].wall_us          # B read half as often
    splits = sweep_axis(32, 3072, 3072, "splits", "bfloat16",
                        mode="modeled")
    assert len({m.plan.splits for m in splits}) == len(splits) > 2
    for m in bms + splits:
        assert m.wall_us == m.modeled_us == mb._modeled_us(
            m.plan, tb.plan_gemm.__kwdefaults__["hw"])


def test_report_has_the_references_header():
    r = tune_gemm(128, 128, 256, "bfloat16", mode="modeled",
                  cache=PlanCache(None))
    md = characterization_report([r])
    assert report._HEADER == jreport._HEADER
    assert md.splitlines()[0] == "# MPGEMM autotuning characterization"
    assert jreport._HEADER in md.splitlines()
    assert "(=analytic)" in md and "modeled" in md
