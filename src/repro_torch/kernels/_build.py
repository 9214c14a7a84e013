"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root (git
ignores ``build/``); the MPGEMM sources share ``csrc/gemm_epilogue.cuh``,
the Hopper designs ``csrc/hopper.cuh``, and the K1, K2 and K3 wgmma
sources ``csrc/mpgemm_wgmma.cuh``.
The hash covers the source, the headers and the flags, so an edited
source never loads a stale library.  :func:`current_stream` gives the
stream handle each launch passes.  Nothing here runs at import:
the first wrapper call on a CUDA tensor builds what it needs, and
:func:`build_all` builds every kernel at once, one nvcc process per source,
all started together.

There is no fallback: a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("mpgemm", "mpgemm_fma", "mpgemm_wgmma", "mpgemm_wgmma_int8",
           "mpgemm_wgmma_f32", "mpgemm_packed", "mpgemm_packed_wgmma",
           "mpgemm_packed_wgmma_int8", "mpgemm_sparse",
           "mpgemm_sparse_wgmma", "mpgemm_sparse_wgmma_int8", "pack",
           "paged_flash", "flash_attention", "flash_attention_wgmma",
           "flash_attention_tf32x3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin",
                                       "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    # The hash covers the shared headers too: an edited header rebuilds
    # every kernel that may include it.
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` that has no current library, with
    one nvcc per source running in parallel, and return the wall seconds
    each build took, by name (an up-to-date kernel is left out).  The
    compiler's output (``-Xptxas=-v`` register and shared-memory report) is
    kept beside each library as ``.log``."""
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(out.with_suffix(".log"), "w") as log:
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           tmp, out)
    seconds = {}
    while len(seconds) < len(procs):
        for name, (proc, _, _) in procs.items():
            if name not in seconds and proc.poll() is not None:
                seconds[name] = time.perf_counter() - t0
        time.sleep(0.1)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            log = out.with_suffix(".log").read_text()
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader never sees half
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def current_stream(t) -> int:
    """The raw handle of the current stream on tensor ``t``'s card, which
    every launch passes its kernel (what ``torch.cuda.current_stream(
    t.device).cuda_stream`` returns, at a tenth of its host cost)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def build_log(name: str) -> Optional[str]:
    """The compiler output of the current build of ``name``, if any."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
