"""Persistent GEMM plan cache -- the read side of the closed planning loop
(port of ``repro.tuning.plan_cache``).

The analytic planner (``core/blocking.py``) predicts and never measures.
This module stores plans that *have* been measured on the card (by
``tuning/microbench.py``) and serves them back to every K1, K2 and K3
launch:

    mpgemm / mpgemm_grouped (kernels/mpgemm.py)
        └─ lookup_plan(...)      -- hit  -> tuned GemmPlan (this module)
                                 -- miss -> plan_gemm(...), the analytic
                                    plan (counted: note_analytic_fallback;
                                    the kernel layer memoises it)

Keying.  A plan is valid for one logical GEMM instance: ``(m, n, k,
a_dtype, b_dtype, out_dtype, trans_a, trans_b, beta != 0, hw)`` plus the
grouped, layout, epilogue, sparsity and mesh tags -- the reference's key,
byte for byte (the port has no sharded path: ``mesh`` is given or empty).  ``hw`` is the card's spec (``core/constants.py::
device_spec``), ``h100_132sm`` on an H100 SXM5: a card with another SM
count, and the reference's TPU names, never read these plans.  The port
adds one tag of its own, ``design`` (``|design=fma``): the fp32 policy's
f32 FMA products tune apart from the tf32x3 ones at the same shape.

Persistence.  JSON on disk, written atomically (tmp + rename), merged with
what other processes wrote; an unknown schema version reads as empty.
Process-global behaviour is set by ``REPRO_TORCH_PLAN_CACHE`` (the port's
own variable: ``REPRO_PLAN_CACHE`` is the reference's and is not read):

    unset          -- in-memory global cache (a tune_gemm result is used by
                      later launches in the same process; nothing persists)
    <path>.json    -- persistent cache at that path, loaded lazily
    "off" / "0"    -- lookups disabled (pure analytic planning)

Counts.  :func:`lookup_counts` gives the lookups by outcome (``hit_tuned``,
``miss``, ``disabled``, ``dropped``: a tuned plan for another payload
tiling or design; ``hit_analytic``: a launch that found its analytic plan
in the kernel layer's memo) and ``fallback``, the analytic plans made on
a miss -- a plain dict that ``chip_smoke.py`` prints; the reference
counts the same through its ``obs`` registry.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import re
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

from repro_torch.core.blocking import (
    GemmPlan, _resolve_dtypes, plan_from_dict, plan_to_dict,
)
from repro_torch.core.constants import DEFAULT_HW, HardwareSpec

ENV = "REPRO_TORCH_PLAN_CACHE"

_SCHEMA_VERSION = 1

_OFF_VALUES = ("off", "0", "none", "disabled")

_log = logging.getLogger(__name__)

_GROUPED_KEY_RE = re.compile(r"^g\d+\|")


def key_namespace(key: str) -> str:
    """Coarse, bounded namespace of a plan-cache key: the structural key
    components (grouped prefix, layout / epilogue / sparsity / mesh
    suffixes), not their full tags.  ``'default'`` is the plain dense 2-D
    GEMM."""
    parts = []
    if _GROUPED_KEY_RE.match(key):
        parts.append("grouped")
    for marker, name in (("|lay=", "layout"), ("|ep=", "epilogue"),
                         ("|sp=", "sparse"), ("|mesh=", "mesh")):
        if marker in key:
            parts.append(name)
    return "+".join(parts) or "default"


@contextlib.contextmanager
def _file_lock(path: Path):
    """Advisory cross-process lock guarding read-merge-rename on ``path``:
    a sibling ``.lock`` file is flocked (never the data file, which the
    rename replaces).  Without fcntl it is a no-op: saves stay atomic,
    merely losing the concurrent-merge guarantee."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-POSIX
        yield
        return
    lock_path = path.with_name(path.name + ".lock")
    with open(lock_path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def make_key(
    m: int,
    n: int,
    k: int,
    a_dtype,
    b_dtype=None,
    out_dtype=None,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    beta: float = 0.0,
    hw: HardwareSpec = DEFAULT_HW,
    g: int = 1,
    layout: str = "",
    epilogue: str = "",
    sparsity: str = "",
    mesh: str = "",
    design: str = "",
) -> str:
    """Canonical cache key for one logical GEMM instance: the reference's
    string, byte for byte, for the same ``hw`` name and tags (``g``,
    ``layout``: ``PackedLayout.tag``, ``epilogue``: ``EpilogueSpec.tag``,
    ``sparsity``: ``TileSparseLayout.tag``, ``mesh``: a sharded GEMM's mesh
    tag, which the reference scopes from a thread-local and the port, with
    no sharded path, takes only as given), each appended only when set.  ``design``
    (the port's own) tags a launch whose design the caller chose, not its
    operands: ``"fma"``, the fp32 policy's products."""
    a_dtype, b_dtype, out_dtype, _ = _resolve_dtypes(a_dtype, b_dtype,
                                                     out_dtype)
    group = f"g{g}|" if g != 1 else ""
    lay = f"|lay={layout}" if layout else ""
    ep = f"|ep={epilogue}" if epilogue else ""
    sp = f"|sp={sparsity}" if sparsity else ""
    ns = f"|mesh={mesh}" if mesh else ""
    dz = f"|design={design}" if design else ""
    return (
        f"{group}m{m}n{n}k{k}"
        f"|a={a_dtype}|b={b_dtype}|out={out_dtype}"
        f"|ta={int(trans_a)}|tb={int(trans_b)}|beta={int(beta != 0.0)}"
        f"|hw={hw.name}{lay}{ep}{sp}{ns}{dz}"
    )


# Bumped by every change of what a lookup can return (a put, a clear, a
# new global cache): the kernel layer's per-launch memo
# (kernels/mpgemm.py) drops its entries when it moves.
_generation = 0


def generation() -> int:
    """The plan world's version: it moves whenever a lookup could return
    another plan than before."""
    return _generation


def _bump() -> None:
    global _generation
    _generation += 1


class PlanCache:
    """JSON-on-disk (or in-memory) map from GEMM key -> tuned
    :class:`GemmPlan`.  Thread-safe; ``path=None`` keeps it in memory.

    Example (runnable on the CPU)::

        >>> from repro_torch.tuning import PlanCache, make_key
        >>> from repro_torch.core.blocking import plan_gemm
        >>> cache = PlanCache("/tmp/plans.json")
        >>> key = make_key(256, 256, 256, "bfloat16")
        >>> cache.put(key, plan_gemm(256, 256, 256, "bfloat16"),
        ...           meta={"wall_us": 12.3})
        >>> cache.save()
        >>> PlanCache("/tmp/plans.json").get(key).bm
        128
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else None
        self._lock = threading.RLock()
        self._entries: Dict[str, dict] = {}
        self._loaded = False
        self._purge_on_save = False

    # -- persistence -------------------------------------------------------

    def _disk_entries(self) -> Dict[str, dict]:
        """Current on-disk entries; {} for missing/corrupt/foreign files."""
        if self.path is None or not self.path.exists():
            return {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}  # corrupt/unreadable cache == empty cache, never a crash
        if not isinstance(raw, dict) or raw.get("version") != _SCHEMA_VERSION:
            return {}
        entries = raw.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._entries = self._disk_entries()

    def save(self) -> None:
        """Atomically persist to ``self.path`` (no-op in memory), merged
        with entries other processes wrote since the load (ours win on a
        collision), unless :meth:`clear` asked for a reset."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock, _file_lock(self.path):
            self._ensure_loaded()
            if self._purge_on_save:
                self._purge_on_save = False
            else:
                merged = dict(self._disk_entries())
                merged.update(self._entries)
                self._entries = merged
            payload = json.dumps(
                {"version": _SCHEMA_VERSION, "entries": self._entries},
                indent=1, sort_keys=True,
            )
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(payload)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        _bump()

    # -- map interface -----------------------------------------------------

    def get(self, key: str) -> Optional[GemmPlan]:
        with self._lock:
            self._ensure_loaded()
            entry = self._entries.get(key)
            if entry is None:
                return None
            try:
                return plan_from_dict(entry["plan"])
            except (KeyError, TypeError):
                return None

    def get_meta(self, key: str) -> Optional[dict]:
        """Measurement metadata stored beside the plan (wall_us, mode, ...)."""
        with self._lock:
            self._ensure_loaded()
            entry = self._entries.get(key)
            return dict(entry.get("meta", {})) if entry else None

    def put(self, key: str, plan: GemmPlan, meta: Optional[dict] = None) -> None:
        with self._lock:
            self._ensure_loaded()
            self._entries[key] = {"plan": plan_to_dict(plan), "meta": meta or {}}
        _bump()

    def keys(self):
        with self._lock:
            self._ensure_loaded()
            return list(self._entries)

    def clear(self) -> None:
        """Drop all entries; the next :meth:`save` rewrites the file from
        scratch instead of merging disk state back in."""
        with self._lock:
            self._entries = {}
            self._loaded = True
            self._purge_on_save = True
        _bump()

    def __len__(self) -> int:
        with self._lock:
            self._ensure_loaded()
            return len(self._entries)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            self._ensure_loaded()
            return key in self._entries


# -- process-global cache ----------------------------------------------------

_global_lock = threading.Lock()
_global_cache: Optional[PlanCache] = None
_global_configured = False


def _env_cache() -> Optional[PlanCache]:
    env = os.environ.get(ENV, "").strip()
    if env.lower() in _OFF_VALUES:
        return None
    if env:
        return PlanCache(env)
    return PlanCache(None)  # in-memory process-global default


def get_plan_cache() -> Optional[PlanCache]:
    """The process-global cache every launch consults (None == disabled),
    made from ``REPRO_TORCH_PLAN_CACHE`` at first use."""
    global _global_cache, _global_configured
    with _global_lock:
        if not _global_configured:
            _global_cache = _env_cache()
            _global_configured = True
        return _global_cache


def set_plan_cache(cache: Optional[PlanCache]) -> Optional[PlanCache]:
    """Install ``cache`` as the process-global cache; returns the previous
    one.  ``None`` disables cached-plan lookup (pure analytic planning)."""
    global _global_cache, _global_configured
    with _global_lock:
        prev = _global_cache if _global_configured else None
        _global_cache = cache
        _global_configured = True
    _bump()
    return prev


def reset_plan_cache() -> None:
    """Forget the global cache, so that the next lookup reads
    ``REPRO_TORCH_PLAN_CACHE`` again."""
    global _global_cache, _global_configured
    with _global_lock:
        _global_cache, _global_configured = None, False
        _fallback_logged_ns.clear()
    _bump()


# -- lookup counts -----------------------------------------------------------

_COUNT_KEYS = ("hit_tuned", "hit_analytic", "miss", "disabled", "dropped",
               "fallback")
_counts: Dict[str, int] = dict.fromkeys(_COUNT_KEYS, 0)


def count_lookup(result: str) -> None:
    """Count one lookup (or analytic ``fallback``) by outcome."""
    _counts[result] += 1


def lookup_counts() -> Dict[str, int]:
    """A copy of the counts by outcome since the last reset."""
    return dict(_counts)


def reset_lookup_counts() -> None:
    for key in _COUNT_KEYS:
        _counts[key] = 0


# -- analytic fallbacks ------------------------------------------------------
#
# A tuned-cache miss falls back to the analytic planner.  The kernel layer
# reports each fallback here (and memoises the plan itself): the fallback is
# counted, and the first one in each key namespace is logged.

_fallback_logged_ns: set = set()


def note_analytic_fallback(key: str) -> None:
    """Record one analytic-planner fallback for a tuned-cache miss: count
    it, and log the first of each key namespace (at INFO: on the card
    every shape falls back until it is tuned)."""
    ns = key_namespace(key)
    count_lookup("fallback")
    with _global_lock:
        first = ns not in _fallback_logged_ns
        _fallback_logged_ns.add(ns)
    if first:
        _log.info(
            "plan cache miss in namespace %r (key %s): the analytic plan "
            "(the design rules) runs. Tune the shape (repro_torch.tuning."
            "tune_gemm) to pin a measured plan; further %r fallbacks are "
            "counted, not logged.", ns, key, ns)


def lookup_plan(
    m: int,
    n: int,
    k: int,
    a_dtype,
    b_dtype=None,
    out_dtype=None,
    *,
    trans_a: bool = False,
    trans_b: bool = False,
    beta: float = 0.0,
    hw: HardwareSpec = DEFAULT_HW,
    g: int = 1,
    layout: str = "",
    epilogue: str = "",
    sparsity: str = "",
    mesh: str = "",
    design: str = "",
) -> Optional[GemmPlan]:
    """Tuned plan for this GEMM instance, or None (miss / cache disabled).

    The read path behind every K1, K2 and K3 launch
    (``kernels/mpgemm.py``); keys as :func:`make_key`.  Every lookup is
    counted as ``hit_tuned`` / ``miss`` / ``disabled``
    (:func:`lookup_counts`; ``hit_analytic`` counts the kernel layer's
    memo hits)."""
    key = make_key(
        m, n, k, a_dtype, b_dtype, out_dtype,
        trans_a=trans_a, trans_b=trans_b, beta=beta, hw=hw, g=g,
        layout=layout, epilogue=epilogue, sparsity=sparsity, mesh=mesh,
        design=design,
    )
    cache = get_plan_cache()
    if cache is None:
        count_lookup("disabled")
        return None
    plan = cache.get(key)
    if plan is not None:
        count_lookup("hit_tuned")
        return plan
    count_lookup("miss")
    return None
