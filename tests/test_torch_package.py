"""Package rules of the PyTorch port (``src/repro_torch``) and its entry
points, checked on the CPU.

* The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``.
* The serving CLI runs the plain path with ``--device cpu`` and refuses to
  run on the CPU when it was asked for the card and none is present.
* Kernel wrappers dispatch by device: the plain version only for CPU
  tensors, never for another device.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(args, cwd=ROOT, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=240)


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert len(MODULES) >= 15


@pytest.mark.parametrize("path", ["src/repro_torch", "chip_smoke.py",
                                  "chip_ab.py"])
def test_sources_name_no_jax_and_no_reference_import(path):
    """Also the imports inside functions, which a module import never runs
    (``chip_smoke.py`` imports torch and the port inside ``main``)."""
    target = ROOT / path
    files = sorted(target.rglob("*.py")) if target.is_dir() else [target]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{f.name}: {n}" for n in names if _forbidden(n)]
    assert not bad


def test_serve_cli_runs_on_cpu_when_asked():
    r = _run(["-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
              "--requests", "2", "--max-new", "4"])
    assert r.returncode == 0, r.stderr
    assert "on cpu: 2 requests, 8 tokens" in r.stdout
    assert r.stdout.count("  req") == 2


def test_serve_cli_without_a_card_exits_nonzero():
    """The default is the card; with none visible the CLI must fail with a
    clear message and not quietly run on the CPU."""
    r = _run(["-m", "repro_torch.launch.serve", "--smoke", "--requests", "1",
              "--max-new", "2"], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
    assert "[serve]" not in r.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card: non-zero exit and no result line, both from the checkout
    and from a directory that holds the script alone."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        r = _run([str(script)], cwd=cwd, CUDA_VISIBLE_DEVICES="")
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_model_defaults_to_the_card_and_refuses_without_one(monkeypatch):
    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = cb.get("phi3-mini-3.8b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    """A tensor on any other device than the CPU never reaches a plain
    version: meta tensors are refused outright, and the launch counters
    stay at zero on the CPU path."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, paged_flash_attention,
    )
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_packed, \
        mpgemm_sparse
    from repro_torch.packing.pack import pack_operand
    from repro_torch.sparse import sparsify_magnitude

    k1, k5 = mpgemm.launches, paged_flash_attention.launches
    k4, k3 = flash_attention.launches, mpgemm_sparse.launches
    k2, k6 = mpgemm_packed.launches, pack_operand.launches
    a = torch.ones(2, 8)
    assert mpgemm(a, torch.ones(8, 4)).shape == (2, 4)
    with pytest.raises(ValueError, match="device"):
        mpgemm(a.to("meta"), torch.ones(8, 4, device="meta"))
    packed = pack_operand(torch.ones(8, 4), (8, 4), dtype="int4")
    assert mpgemm(a, packed).shape == (2, 4)
    with pytest.raises(ValueError, match="device"):
        mpgemm(a.to("meta"), packed.to("meta"))
    with pytest.raises(ValueError, match="device"):
        pack_operand(torch.ones(8, 4, device="meta"), (8, 4), dtype="int4")
    sparse = sparsify_magnitude(torch.ones(8, 4), (4, 4), density=0.5)
    assert mpgemm(a, sparse).shape == (2, 4)
    with pytest.raises(ValueError, match="device"):
        mpgemm(a.to("meta"), sparse.to("meta"))
    q = torch.ones(1, 2, 1, 8)
    pages = torch.ones(2, 2, 4, 8)
    i32 = dict(dtype=torch.int32)
    args = (torch.ones(1, 1, **i32), torch.zeros(1, **i32),
            torch.ones(1, **i32))
    assert paged_flash_attention(q, pages, pages, *args).shape == q.shape
    with pytest.raises(ValueError, match="device"):
        paged_flash_attention(q.to("meta"), pages.to("meta"),
                              pages.to("meta"), *(t.to("meta") for t in args))
    kv = torch.ones(1, 1, 5, 8)
    assert flash_attention(q, kv, kv, causal=False).shape == q.shape
    with pytest.raises(ValueError, match="device"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    assert (mpgemm.launches, paged_flash_attention.launches) == (k1, k5)
    assert (mpgemm_packed.launches, pack_operand.launches) == (k2, k6)
    assert (flash_attention.launches, mpgemm_sparse.launches) == (k4, k3)


def test_importing_the_kernels_builds_nothing():
    """Kernels build at their first launch, never at import; K4's and K3's
    sources are among the ones ``build_all`` compiles."""
    r = _run(["-c", "import repro_torch.kernels.mpgemm, "
              "repro_torch.kernels.flash_attention, "
              "repro_torch.models.attention, "
              "repro_torch.packing.params, repro_torch.sparse, "
              "repro_torch.kernels._build as b; "
              "assert 'flash_attention' in b.KERNELS; "
              "assert (b.CSRC / 'flash_attention.cu').is_file(); "
              "assert 'mpgemm_sparse' in b.KERNELS; "
              "assert (b.CSRC / 'mpgemm_sparse.cu').is_file(); "
              "print(b.BUILD_DIR, b._loaded)"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("{}")
