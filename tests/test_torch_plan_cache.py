"""The port's plan cache (``repro_torch.tuning.plan_cache``) against the
reference's (``repro.tuning.plan_cache``), and the kernel layer's reading
of it (``kernels/mpgemm.py::_resolve_plan``, which a CPU tensor reaches
too: plans are resolved from shapes, dtypes and the card's spec).

* ``make_key`` is the reference's string, byte for byte, for the same
  ``hw`` name and every tag (``g``, ``layout``, ``epilogue``,
  ``sparsity``, ``mesh``);
* ``REPRO_TORCH_PLAN_CACHE`` is read and ``REPRO_PLAN_CACHE`` is not; a
  cache file survives into a new process;
* a launch takes a tuned plan over the analytic one, drops a tuned plan
  for another payload tiling or design, memoises its plan until the cache
  changes, and raises on a tuned plan outside the kernel's limits.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.core import constants as jc  # noqa: E402
from repro.tuning import plan_cache as jpc  # noqa: E402
from repro_torch.core.blocking import plan_gemm, plan_with_blocks  # noqa: E402
from repro_torch.core.constants import DEFAULT_HW  # noqa: E402
from repro_torch.core.gemm_spec import LINEAR, EpilogueSpec  # noqa: E402
from repro_torch.kernels import mpgemm as K  # noqa: E402
from repro_torch.tuning import plan_cache as pc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JHW = dataclasses.replace(jc.DEFAULT_HW, name=DEFAULT_HW.name)


@pytest.fixture
def cache():
    """A fresh in-memory global cache, and the default back afterwards."""
    fresh = pc.PlanCache(None)
    pc.set_plan_cache(fresh)
    pc.reset_lookup_counts()
    yield fresh
    pc.reset_plan_cache()


@pytest.mark.parametrize("shape,dtypes,kw", [
    ((32, 3072, 3072), ("bfloat16",), {}),
    ((2, 8192, 3072), ("int8", "int8", "int32"),
     dict(trans_a=True, beta=2.0)),
    ((512, 1024, 1024), ("float32", None, "bfloat16"),
     dict(trans_b=True, g=32, epilogue="gated-silu")),
    ((2, 3072, 3072), ("bfloat16", "int4"),
     dict(layout="packB128x128int4")),
    ((2, 3072, 3072), ("bfloat16", "fp8e4m3"),
     dict(layout="packB128x128fp8e4m3", epilogue="residual")),
    ((2, 3072, 3072), ("int8", "int8"),
     dict(g=8, sparsity="spB128x128int8-nnz9of18-0123abcd")),
    ((4, 256, 512), ("bfloat16",), dict(mesh="tp4")),
])
def test_make_key_is_the_references(shape, dtypes, kw):
    assert pc.make_key(*shape, *dtypes, **kw) == jpc.make_key(
        *shape, *dtypes, hw=JHW, **kw)
    # The reference's thread-local mesh scope writes what the port takes
    # as ``mesh=``.
    if "mesh" not in kw:
        with jpc.mesh_namespace("dp2"):
            assert pc.make_key(*shape, *dtypes, mesh="dp2", **kw) == \
                jpc.make_key(*shape, *dtypes, hw=JHW, **kw)
    assert pc.make_key(*shape, *dtypes, **kw).count("|hw=h100_132sm") == 1
    # torch dtypes key as their names; the port's own design tag is a
    # suffix the reference never writes.
    assert pc.make_key(*shape, *(getattr(torch, d) if d in (
        "bfloat16", "int8", "float32", "int32") else d for d in dtypes),
        **kw) == pc.make_key(*shape, *dtypes, **kw)
    assert pc.make_key(*shape, *dtypes, design="fma", **kw).endswith(
        "|design=fma")


def test_environment_variable_is_the_ports(tmp_path, monkeypatch):
    mine, theirs = tmp_path / "mine.json", tmp_path / "theirs.json"
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(theirs))
    monkeypatch.delenv(pc.ENV, raising=False)
    pc.reset_plan_cache()
    try:
        assert pc.get_plan_cache().path is None          # in-memory default
        monkeypatch.setenv(pc.ENV, str(mine))
        pc.reset_plan_cache()
        assert pc.get_plan_cache().path == mine
        monkeypatch.setenv(pc.ENV, "off")
        pc.reset_plan_cache()
        assert pc.get_plan_cache() is None
        assert pc.lookup_plan(32, 64, 64, "bfloat16") is None
        assert pc.lookup_counts()["disabled"] >= 1
    finally:
        monkeypatch.delenv(pc.ENV, raising=False)
        pc.reset_plan_cache()
    assert not theirs.exists()


def test_cache_file_survives_a_new_process(tmp_path, monkeypatch):
    """A plan tuned and saved here is read from the file by a new process
    through ``REPRO_TORCH_PLAN_CACHE``, and not through the reference's
    variable."""
    path = tmp_path / "plans.json"
    key = pc.make_key(32, 3072, 3072, "bfloat16")
    plan = plan_with_blocks(32, 3072, 3072, 64, 128, 64, "bfloat16",
                            splits=4, per=12)
    disk = pc.PlanCache(path)
    disk.put(key, plan, meta={"wall_us": 1.0})
    disk.save()
    raw = json.loads(path.read_text())
    assert raw["version"] == 1 and key in raw["entries"]
    code = ("import json, sys; from repro_torch.tuning import lookup_plan, "
            "lookup_counts; p = lookup_plan(32, 3072, 3072, 'bfloat16'); "
            "print(json.dumps([p.bm, p.splits, p.per] if p else None), "
            "lookup_counts()['hit_tuned'])")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("REPRO_PLAN_CACHE", None)
    env[pc.ENV] = str(path)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[64, 4, 12] 1", (out.stdout, out.stderr)
    # The reference's variable names no file of the port's.
    monkeypatch.delenv(pc.ENV, raising=False)
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(path))
    pc.reset_plan_cache()
    try:
        assert pc.lookup_plan(32, 3072, 3072, "bfloat16") is None
    finally:
        pc.reset_plan_cache()


def test_cache_save_merges_and_clears(tmp_path):
    path = tmp_path / "p.json"
    a, b = pc.PlanCache(path), pc.PlanCache(path)
    p1 = plan_gemm(32, 256, 256, "bfloat16")
    p2 = plan_gemm(64, 256, 256, "bfloat16")
    a.put("k1", p1)
    a.save()
    b.put("k2", p2)
    b.save()                                  # merges a's entry back in
    assert set(pc.PlanCache(path).keys()) == {"k1", "k2"}
    assert pc.PlanCache(path).get("k2") == p2
    b.clear()
    b.save()
    assert len(pc.PlanCache(path)) == 0
    path.write_text("{not json")
    assert len(pc.PlanCache(path)) == 0       # corrupt == empty


def _launch(a, n, k, design="wgmma", layout=None, sparse=False,
            epilogue=LINEAR, plan=None, g=1):
    m = a.shape[-2]
    b_dtype = layout.dtype if layout is not None else a.dtype
    out = torch.int32 if a.dtype == torch.int8 and layout is None else \
        torch.bfloat16
    return K._resolve_plan(plan, design, a, b_dtype, m, n, k, g, False,
                           False, out, epilogue, layout, sparse)


def test_tuned_plan_wins_and_is_memoised(cache):
    a = torch.zeros(32, 3072, dtype=torch.bfloat16)
    analytic = _launch(a, 3072, 3072)
    assert pc.lookup_counts()["miss"] == 1
    assert pc.lookup_counts()["fallback"] == 1
    assert analytic == plan_gemm(32, 3072, 3072, "bfloat16")
    assert _launch(a, 3072, 3072) is analytic
    assert pc.lookup_counts()["hit_analytic"] == 1
    tuned = plan_with_blocks(32, 3072, 3072, 64, 128, 64, "bfloat16",
                             splits=4, per=12, notes="tuned")
    cache.put(pc.make_key(32, 3072, 3072, "bfloat16"), tuned)
    assert _launch(a, 3072, 3072) == tuned        # the put dropped the memo
    assert _launch(a, 3072, 3072) == tuned
    assert pc.lookup_counts()["hit_tuned"] == 2
    # Another epilogue is another key: the analytic plan.
    gated = EpilogueSpec(kind="gated", activation="silu")
    assert _launch(a, 3072, 3072, epilogue=gated).split == analytic.split


def test_tuned_plan_outside_the_limits_raises(cache):
    a = torch.zeros(32, 3072, dtype=torch.bfloat16)
    key = pc.make_key(32, 3072, 3072, "bfloat16")
    good = plan_gemm(32, 3072, 3072, "bfloat16")
    for bad in (dataclasses.replace(good, bm=96),
                dataclasses.replace(good, splits=49, per=1),
                dataclasses.replace(good, stages=3),
                dataclasses.replace(good, bk=128)):
        cache.put(key, bad)
        with pytest.raises(ValueError, match="outside the kernel's limits"):
            _launch(a, 3072, 3072)
        with pytest.raises(ValueError, match="outside the kernel's limits"):
            _launch(a, 3072, 3072, plan=bad)


def test_tuned_plan_for_another_tiling_or_design_is_dropped(cache):
    from repro_torch.packing.pack import pack_operand
    w = torch.randn(512, 384, generator=torch.Generator().manual_seed(0))
    packed = pack_operand(w, (128, 128), dtype="int4")
    a = torch.zeros(8, 512, dtype=torch.bfloat16)
    analytic = _launch(a, 384, 512, layout=packed.layout)
    assert (analytic.bk, analytic.bn) == (128, 128)
    assert analytic.split == K.k2_split(8, 384, 512)
    other = plan_with_blocks(8, 384, 512, 64, 128, 64, "bfloat16", "int4",
                             layout="packed", splits=1, per=8)
    cache.put(pc.make_key(8, 384, 512, "bfloat16", "int4", "bfloat16",
                          layout=packed.layout.tag), other)
    assert _launch(a, 384, 512, layout=packed.layout) == analytic
    assert pc.lookup_counts()["dropped"] == 1
    # A tf32x3 plan does not run an f32 launch the fp32 policy keeps on
    # fma: that launch keys apart (design=fma) and never sees it; a simt
    # launch (misaligned operands) takes no plan and looks none up; a
    # plan of another design under the key is dropped.
    f = torch.zeros(40, 512)
    key = pc.make_key(40, 96, 512, "float32", "float32", "bfloat16")
    cache.put(key, plan_gemm(40, 96, 512, "float32"))
    assert _launch(f, 96, 512, design="fma").design == "fma"
    lookups = sum(pc.lookup_counts().values())
    assert _launch(f, 96, 512, design="simt") is None
    assert sum(pc.lookup_counts().values()) == lookups
    cache.put(key, plan_gemm(40, 96, 512, "bfloat16"))
    assert _launch(f, 96, 512, design="tf32x3").design == "tf32x3"
    assert pc.lookup_counts()["dropped"] == 2


def test_sparse_launch_keys_by_its_pattern(cache):
    from repro_torch.sparse import sparsify_magnitude
    w = torch.randn(1024, 256, generator=torch.Generator().manual_seed(1))
    sp = sparsify_magnitude(w, (128, 128), density=0.5,
                            dtype=torch.bfloat16)
    a = torch.zeros(2, 1024, dtype=torch.bfloat16)
    plan = _launch(a, 256, 1024, layout=sp.layout, sparse=True)
    assert plan.split == K.k3_split(2, 256, sp.layout.max_column_tiles)
    key = pc.make_key(2, 256, 1024, "bfloat16", "bfloat16", "bfloat16",
                      sparsity=sp.layout.tag)
    assert pc.lookup_counts()["fallback"] == 1
    tuned = dataclasses.replace(plan, bm=128, splits=1,
                                per=sp.layout.max_column_tiles)
    cache.put(key, tuned)
    assert _launch(a, 256, 1024, layout=sp.layout, sparse=True) == tuned
    # Another pattern of the same shape and density keys apart.
    other = sparsify_magnitude(-w.flip(0), (128, 128), density=0.5,
                               dtype=torch.bfloat16)
    assert other.layout.tag != sp.layout.tag
    assert _launch(a, 256, 1024, layout=other.layout, sparse=True) != tuned


@pytest.mark.parametrize("sparse", [False, True])
def test_repeated_astype_launches_add_no_plan(cache, sparse):
    """The fp32 gates over a bf16 payload cast it (``astype``) on every
    call, a new layout each time: the launches after the first hit the
    memo and leave it the same size, and the pattern's digest is handed
    on, not recomputed."""
    from repro_torch.packing.pack import pack_operand
    from repro_torch.sparse import sparsify_magnitude
    w = torch.randn(512, 256, generator=torch.Generator().manual_seed(2))
    b = (sparsify_magnitude(w, (128, 128), density=0.5, dtype=torch.bfloat16)
         if sparse else pack_operand(w, (128, 128), dtype="bfloat16"))
    a = torch.zeros(4, 512)
    first = _launch(a, 256, 512, layout=b.astype(torch.float32).layout,
                    sparse=sparse)
    size = len(K._plans)
    for _ in range(3):
        cast = b.astype(torch.float32)
        if sparse:
            assert "pattern_digest" in vars(cast.layout)
        assert _launch(a, 256, 512, layout=cast.layout,
                       sparse=sparse) is first
    assert len(K._plans) == size
    assert pc.lookup_counts()["hit_analytic"] == 3
