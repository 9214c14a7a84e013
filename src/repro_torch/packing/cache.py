"""The packed-weight cache (port of ``repro.packing.cache``): pack once,
load from the cache after.

**Keys** name one packed or tile-sparse artifact exactly, as the
reference's ``make_weight_key`` does, plus one field naming the port:

    ``<name>|<layout.tag>|[g{G}|]k{K}n{N}|src=<dtype>|sha=<16 hex>|impl=repro_torch``

The layout tag carries the blocks and the payload dtype (a sparse layout's
also its nnz and pattern digest), so a plan, pattern or format change is a
miss; the digest is sha256 over the weight's shape, dtype name and raw
bytes, as the reference's over its numpy array (a bf16 weight hashes as
``'bfloat16'`` over its 2-byte values), so a new checkpoint is a miss.
The last field keeps the reference's cache and the port's from reading
each other's files: their payload bytes may differ by one f32 ulp in a
tile scale (ROADMAP C, ``_pack_quant_kernel``).

**Files.**  A cache with a ``path`` is a directory: ``index.json``
(versioned, replaced atomically under the plan cache's advisory
``_file_lock``, merged with concurrent writers) maps keys to ``.npz``
files, each written to a temporary file and renamed.  A payload goes to
disk as its raw bytes (bf16, fp8 and int4 storage have no numpy dtype, or
lose it in ``np.savez``), and the layout restores dtype and shape.  A
corrupt or mismatched entry is a miss, never a crash.  A cache without a
path keeps host copies in memory.  Either way a hit is moved to the
device of the weight it stands for.

**The process-global cache** is ``REPRO_TORCH_PACK_CACHE`` (never the
reference's ``REPRO_PACK_CACHE``): a directory makes it persistent;
unset, empty or ``off`` / ``0`` / ``none`` / ``disabled`` turns it off.
Off is the port's default, where the reference's is an in-memory cache:
that would pin every packed payload of every model loaded in the process
and hash every f32 draw at every load.  :func:`set_pack_cache` installs
any cache, an in-memory ``PackedWeightCache(None)`` too.
:func:`lookup_counts` counts reads by layout kind and outcome.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import threading
import zipfile
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.codecs import dtype_name, torch_dtype
from repro_torch.packing.layout import PackedLayout, PackedOperand

_SCHEMA_VERSION = 1

_OFF_VALUES = ("", "off", "0", "none", "disabled")

ENV_VAR = "REPRO_TORCH_PACK_CACHE"

# The key's last field: the port's artifacts, never the reference's.
PORT_FIELD = "impl=repro_torch"

Operand = Union[PackedOperand, "TileSparseOperand"]

_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def _count(kind: str, result: str) -> None:
    with _counts_lock:
        key = f"{kind}_{result}"
        _counts[key] = _counts.get(key, 0) + 1


def lookup_counts() -> Dict[str, int]:
    """Reads of every cache since the last reset, by ``<kind>_<outcome>``
    (``packed_hit``, ``tile_sparse_miss``, ...)."""
    with _counts_lock:
        return dict(_counts)


def reset_lookup_counts() -> None:
    with _counts_lock:
        _counts.clear()


def _file_lock(path: Path):
    # Imported here: tuning imports the kernel layer, which this module's
    # importers (packing/params.py) sit beside.
    from repro_torch.tuning.plan_cache import _file_lock as impl
    return impl(path)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of ``t`` (contiguous, on the host) as a uint8 array."""
    return t.detach().contiguous().cpu().reshape(-1).view(
        torch.uint8).numpy()


def weight_digest(w: torch.Tensor) -> str:
    """sha256 over ``str(shape)``, the dtype name and the raw bytes: the
    reference's ``weight_digest`` of the same values."""
    h = hashlib.sha256()
    h.update(str(tuple(w.shape)).encode())
    h.update(dtype_name(w.dtype).encode())
    h.update(_host_bytes(w))
    return h.hexdigest()


def make_weight_key(name: str, w: torch.Tensor, layout) -> str:
    """The cache key of ``w`` packed or sparsified into ``layout``: the
    reference's key, then :data:`PORT_FIELD`."""
    group = f"g{layout.g}|" if layout.g != 1 else ""
    return (f"{name}|{layout.tag}|{group}k{layout.k}n{layout.n}"
            f"|src={layout.orig_dtype}|sha={weight_digest(w)[:16]}"
            f"|{PORT_FIELD}")


def _kinds():
    """Layout kind -> (layout class, operand class); sparse imported here,
    as ``repro_torch.sparse`` imports the packing layer."""
    from repro_torch.sparse.layout import TileSparseLayout, TileSparseOperand
    return {"packed": (PackedLayout, PackedOperand),
            "tile_sparse": (TileSparseLayout, TileSparseOperand)}


def _kind_of(layout) -> str:
    return "packed" if isinstance(layout, PackedLayout) else "tile_sparse"


def _layout_to_dict(layout) -> dict:
    d = dataclasses.asdict(layout)
    d["kind"] = _kind_of(layout)
    return d


def _layout_from_dict(d: dict):
    d = dict(d)
    layout_cls, _ = _kinds()[d.pop("kind")]
    return layout_cls(**d)


def _payload_dtype(layout) -> torch.dtype:
    if isinstance(layout, PackedLayout):
        return layout.storage_dtype
    return torch_dtype(layout.dtype)


def _operand(layout, payload, scales) -> Operand:
    _, operand_cls = _kinds()[_kind_of(layout)]
    return operand_cls(payload, scales, layout)


def _load(file: Path, layout) -> Operand:
    """The operand stored in ``file`` on the host; raises on any mismatch
    with ``layout``."""
    with np.load(file) as data:
        raw = torch.from_numpy(np.array(data["payload"], dtype=np.uint8))
        scales = (torch.from_numpy(np.array(data["scales"],
                                            dtype=np.float32))
                  if "scales" in data.files else None)
    payload = raw.view(_payload_dtype(layout)).reshape(layout.payload_shape)
    if (scales is None) != (layout.scales_shape is None) or (
            scales is not None
            and tuple(scales.shape) != tuple(layout.scales_shape)):
        raise ValueError(f"scales do not fit {layout.describe()}")
    return _operand(layout, payload, scales)


class PackedWeightCache:
    """A directory-backed (``path``) or in-memory (``path=None``) map from
    :func:`make_weight_key` keys to packed or tile-sparse operands.
    Thread-safe; ``hits`` and ``misses`` count this instance's
    :meth:`get_or_pack` / :meth:`get_or_build` lookups."""

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else None
        self._lock = threading.RLock()
        self._mem: Dict[str, Operand] = {}
        self.hits = 0
        self.misses = 0

    # -- index persistence ---------------------------------------------------

    def _index_path(self) -> Path:
        return self.path / "index.json"

    def _read_index(self) -> Dict[str, dict]:
        if self.path is None or not self._index_path().exists():
            return {}
        try:
            raw = json.loads(self._index_path().read_text())
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict) or raw.get("version") != _SCHEMA_VERSION:
            return {}
        entries = raw.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def _write_index(self, entries: Dict[str, dict]) -> None:
        text = json.dumps({"version": _SCHEMA_VERSION, "entries": entries},
                          indent=1, sort_keys=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self._index_path())
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- map interface -------------------------------------------------------

    def get(self, key: str, device="cpu") -> Optional[Operand]:
        """The operand under ``key`` on ``device``, or None."""
        with self._lock:
            if self.path is None:
                hit = self._mem.get(key)
                return None if hit is None else hit.to(device)
            entry = self._read_index().get(key)
            if entry is None:
                return None
            try:
                layout = _layout_from_dict(entry["layout"])
                hit = _load(self.path / entry["file"], layout)
            except (OSError, EOFError, KeyError, TypeError, ValueError,
                    RuntimeError, zipfile.BadZipFile):
                return None      # a corrupt entry is a miss, never a crash
            return hit.to(device)

    def put(self, key: str, op: Operand) -> None:
        with self._lock:
            if self.path is None:
                self._mem[key] = op.to("cpu")
                return
            self.path.mkdir(parents=True, exist_ok=True)
            fname = hashlib.sha256(key.encode()).hexdigest()[:24] + ".npz"
            arrays = {"payload": _host_bytes(op.payload)}
            if op.scales is not None:
                arrays["scales"] = op.scales.detach().float().cpu().numpy()
            fd, tmp = tempfile.mkstemp(dir=str(self.path), suffix=".npz.tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **arrays)
                os.replace(tmp, self.path / fname)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            with _file_lock(self._index_path()):
                entries = self._read_index()      # merge concurrent writers
                entries[key] = {"file": fname,
                                "layout": _layout_to_dict(op.layout)}
                self._write_index(entries)

    def keys(self):
        with self._lock:
            return sorted(set(self._read_index()) | set(self._mem))

    def clear(self) -> None:
        """Drop every entry: the memory map and, for a directory, the index
        and its payload files."""
        with self._lock:
            self._mem = {}
            if self.path is None or not self.path.exists():
                return
            with _file_lock(self._index_path()):
                for entry in self._read_index().values():
                    f = self.path / entry.get("file", "")
                    if f.suffix == ".npz" and f.exists():
                        f.unlink()
                self._write_index({})

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._mem or key in self._read_index()

    def __len__(self) -> int:
        return len(self.keys())

    # -- lookups -------------------------------------------------------------

    def get_or_build(self, name: str, w: torch.Tensor, layout,
                     build_fn: Callable[[], Operand]) -> Operand:
        """The cached operand of ``w`` in ``layout`` under ``name`` (on
        ``w``'s device), else ``build_fn()``, cached."""
        key = make_weight_key(name, w, layout)
        kind = _kind_of(layout)
        hit = self.get(key, device=w.device)
        if hit is not None:
            self.hits += 1
            _count(kind, "hit")
            return hit
        self.misses += 1
        _count(kind, "miss")
        built = build_fn()
        self.put(key, built)
        return built

    def get_or_pack(self, name: str, w: torch.Tensor, blocks, *,
                    trans_w: bool = False, dtype=None) -> PackedOperand:
        """``pack_operand(w, blocks, trans_w=, dtype=)`` through the cache:
        a hit launches no packer."""
        from repro_torch.packing.pack import _layout_for, pack_operand
        layout = _layout_for(w, *blocks, trans_w=trans_w, dtype=dtype)
        return self.get_or_build(
            name, w, layout,
            lambda: pack_operand(w, blocks, trans_w=trans_w, dtype=dtype))


# -- the process-global cache -------------------------------------------------

_global_lock = threading.Lock()
_global_cache: Optional[PackedWeightCache] = None
_global_configured = False


def _env_cache() -> Optional[PackedWeightCache]:
    env = os.environ.get(ENV_VAR, "").strip()
    if env.lower() in _OFF_VALUES:
        return None
    return PackedWeightCache(env)


def get_pack_cache() -> Optional[PackedWeightCache]:
    """The process-global packed-weight cache (None: off), from
    ``REPRO_TORCH_PACK_CACHE`` at the first call unless set."""
    global _global_cache, _global_configured
    with _global_lock:
        if not _global_configured:
            _global_cache = _env_cache()
            _global_configured = True
        return _global_cache


def set_pack_cache(cache: Optional[PackedWeightCache]
                   ) -> Optional[PackedWeightCache]:
    """Install ``cache`` (None: off) as the process-global cache; returns
    the one before."""
    global _global_cache, _global_configured
    with _global_lock:
        prev = _global_cache if _global_configured else None
        _global_cache = cache
        _global_configured = True
        return prev
