"""Tile-sparse operand layout metadata and :class:`TileSparseOperand`
(port of ``repro.sparse.layout``).

    logical weight  w[k, n]   (or w[n, k] under ``trans_w``)
        |  sparsify (sparse/sparsify.py): tile on the (bk, bn) lattice,
        |  score tiles, drop the weak ones, zero-pad edges, resolve the
        |  transpose, optionally per-tile int8 quantize
        v
    payload[nnz + 1, bk, bn]     -- stored tiles in column-major (g, j)
                                    order, plus ONE trailing all-zero tile
    scales [nnz + 1, 1] f32      -- int8 payloads only
    TileSparseLayout             -- BSR (indptr, indices) over the lattice

The structure is column-major over the ``g * nnb`` output-tile columns:
column ``c`` (group ``c // nnb``, n-tile ``c % nnb``) stores the k-tile
indices ``indices[indptr[c]:indptr[c+1]]`` in ascending order, and its
stored tiles sit at the same positions of the payload.  The tile-sparse
GEMM (K3, ``kernels/csrc/mpgemm_sparse.cu``) walks exactly that slice for
each output column; a column with no stored tile still gets its epilogue
(bias, activation, gate, residual) on a zero sum.  The reference's TPU
kernel visits the trailing zero tile for such a column (an *anchor*
visit, counted by ``schedule_len``); the port's kernel needs no read for
it, but the payload keeps the tile so that its bytes equal the
reference's.

:class:`TileSparseOperand` carries the index arrays as int32 tensors
beside the payload (``indptr``, ``indices``), built once and moved with it
by :meth:`TileSparseOperand.to`, so that no launch copies them from the
host.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.codecs import dtype_name, torch_dtype


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class TileSparseLayout:
    """Static description of one tile-sparse operand (the reference's
    fields and checks).

    ``k``/``n`` are the LOGICAL GEMM dims, a ``trans_w`` source's transpose
    resolved at sparsify time; ``indptr``/``indices`` the BSR column
    structure (tuples, so the layout hashes); ``dtype`` the payload dtype
    (``int8`` implies per-tile scales); ``g`` > 1 a grouped operand whose
    per-group patterns are folded into one flat column structure.
    """

    k: int
    n: int
    bk: int
    bn: int
    dtype: str
    orig_dtype: str
    indptr: Tuple[int, ...]
    indices: Tuple[int, ...]
    trans_w: bool = False
    g: int = 1

    def __post_init__(self):
        object.__setattr__(self, "indptr", tuple(int(i) for i in self.indptr))
        object.__setattr__(self, "indices",
                           tuple(int(i) for i in self.indices))
        ncols = self.g * self.nnb
        if len(self.indptr) != ncols + 1:
            raise ValueError(
                f"indptr must have g*nnb+1 = {ncols + 1} entries, got "
                f"{len(self.indptr)}")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.indices):
            raise ValueError("indptr must start at 0 and end at len(indices)")
        for c in range(ncols):
            lo, hi = self.indptr[c], self.indptr[c + 1]
            if hi < lo:
                raise ValueError("indptr must be non-decreasing")
            col = self.indices[lo:hi]
            if any(kk < 0 or kk >= self.nkb for kk in col):
                raise ValueError(
                    f"column {c} has k-tile index outside [0, {self.nkb})")
            if any(col[i] >= col[i + 1] for i in range(len(col) - 1)):
                raise ValueError(
                    f"column {c} k-tile indices must be strictly ascending")

    @property
    def nkb(self) -> int:
        return _cdiv(self.k, self.bk)

    @property
    def nnb(self) -> int:
        return _cdiv(self.n, self.bn)

    @property
    def nnz(self) -> int:
        """Stored tiles across all groups and columns."""
        return len(self.indices)

    @functools.cached_property
    def max_column_tiles(self) -> int:
        """The most stored tiles of any output column (K3's wgmma split,
        ``core/blocking.py::k3_split``), from the host-side ``indptr``:
        computed once a layout, so that no launch reads the device copy
        or walks the tuple."""
        return max((self.indptr[c + 1] - self.indptr[c]
                    for c in range(len(self.indptr) - 1)), default=0)

    @property
    def ntiles(self) -> int:
        """Tiles of the dense lattice."""
        return self.g * self.nkb * self.nnb

    @property
    def density(self) -> float:
        return self.nnz / max(1, self.ntiles)

    @property
    def per_tile_scales(self) -> bool:
        return self.dtype == "int8"

    @property
    def payload_shape(self) -> Tuple[int, ...]:
        # +1: the shared trailing zero tile.
        return (self.nnz + 1, self.bk, self.bn)

    @property
    def scales_shape(self) -> Optional[Tuple[int, ...]]:
        if not self.per_tile_scales:
            return None
        return (self.nnz + 1, 1)

    @property
    def schedule_len(self) -> int:
        """Tile visits of the reference's walk: nnz plus one anchor per
        empty column."""
        empty = sum(1 for c in range(self.g * self.nnb)
                    if self.indptr[c] == self.indptr[c + 1])
        return self.nnz + empty

    @functools.cached_property
    def pattern_digest(self) -> str:
        """Short content fingerprint of the sparsity pattern (computed once
        a pattern: :meth:`TileSparseOperand.astype` hands it on)."""
        h = hashlib.sha256()
        h.update(repr((self.indptr, self.indices)).encode())
        return h.hexdigest()[:8]

    @property
    def tag(self) -> str:
        """Layout namespace tag (blocks, payload dtype, nnz and pattern)."""
        return (f"spB{self.bk}x{self.bn}{self.dtype}"
                f"-nnz{self.nnz}of{self.ntiles}-{self.pattern_digest}")

    def describe(self) -> str:
        shape = f"{self.k}x{self.n}"
        if self.g != 1:
            shape = f"{self.g}x{shape}"
        t = "ᵀ" if self.trans_w else ""
        return (f"TileSparseLayout[{shape}{t} {self.orig_dtype}->{self.dtype}"
                f" tiles=({self.bk},{self.bn}) nnz={self.nnz}/{self.ntiles}"
                f" d={self.density:.2f}]")


@dataclasses.dataclass(frozen=True)
class SparseSchedule:
    """The reference kernel's visit schedule of one layout: one entry per
    tile visit, column-major over (g, j), stored tiles in ascending k
    order plus one anchor entry per empty column pointing at the trailing
    zero tile.  int32 arrays of length ``layout.schedule_len``."""

    kk: np.ndarray      # k-tile index of the visit
    jj: np.ndarray      # n-tile column of the visit
    gg: np.ndarray      # group of the visit (zeros for 2-D)
    slot: np.ndarray    # payload tile to read (the zero tile for anchors)
    first: np.ndarray   # 1 == first visit of its column
    last: np.ndarray    # 1 == last visit of its column


@functools.lru_cache(maxsize=256)
def build_schedule(layout: TileSparseLayout) -> SparseSchedule:
    """Lower a layout's BSR structure to the visit schedule (cached on the
    hashable layout).  K3 walks ``indptr``/``indices`` directly; the
    schedule describes the same walk, anchors included."""
    nnb = layout.nnb
    zero_slot = layout.nnz
    kk, jj, gg, slot, first, last = [], [], [], [], [], []
    for c in range(layout.g * nnb):
        lo, hi = layout.indptr[c], layout.indptr[c + 1]
        col = layout.indices[lo:hi] if hi > lo else (0,)  # anchor visit
        for i, kt in enumerate(col):
            kk.append(kt)
            jj.append(c % nnb)
            gg.append(c // nnb)
            slot.append(lo + i if hi > lo else zero_slot)
            first.append(1 if i == 0 else 0)
            last.append(1 if i == len(col) - 1 else 0)

    def as32(v):
        return np.asarray(v, np.int32)

    return SparseSchedule(kk=as32(kk), jj=as32(jj), gg=as32(gg),
                          slot=as32(slot), first=as32(first), last=as32(last))


class TileSparseOperand:
    """A tile-sparse GEMM operand: stored tiles, optional per-tile scales,
    the layout, and the layout's ``indptr`` / ``indices`` as int32 tensors
    on the payload's device (made from the layout when not given).
    ``mp_dot`` and ``mpgemm`` dispatch on the type."""

    __slots__ = ("payload", "scales", "layout", "indptr", "indices")

    def __init__(self, payload: torch.Tensor,
                 scales: Optional[torch.Tensor], layout: TileSparseLayout,
                 indptr: Optional[torch.Tensor] = None,
                 indices: Optional[torch.Tensor] = None):
        self.payload = payload
        self.scales = scales
        self.layout = layout
        dev = payload.device
        if indptr is None:
            indptr = torch.tensor(layout.indptr, dtype=torch.int32,
                                  device=dev)
        if indices is None:
            indices = torch.tensor(layout.indices, dtype=torch.int32,
                                   device=dev)
        self.indptr = indptr
        self.indices = indices

    @property
    def shape(self) -> Tuple[int, ...]:
        """The LOGICAL (transpose-resolved) shape: (k, n) / (g, k, n)."""
        base = (self.layout.k, self.layout.n)
        return (self.layout.g,) + base if self.layout.g != 1 else base

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.layout.dtype)

    @property
    def nbytes(self) -> int:
        """Payload and scale bytes (the reference's count; the index
        tensors are metadata)."""
        total = self.payload.numel() * self.payload.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return total

    def astype(self, dtype) -> "TileSparseOperand":
        """Payload cast for float payloads (no-op when the dtype matches or
        the payload is int8)."""
        dtype = torch_dtype(dtype)
        if self.layout.per_tile_scales or self.payload.dtype == dtype:
            return self
        layout = dataclasses.replace(self.layout, dtype=dtype_name(dtype))
        # The pattern is the same: hand on what is computed from it (once,
        # on this operand's layout), so that a cast a call costs no walk.
        for name in ("max_column_tiles", "pattern_digest"):
            vars(layout)[name] = getattr(self.layout, name)
        return TileSparseOperand(self.payload.to(dtype), None, layout,
                                 self.indptr, self.indices)

    def to(self, device) -> "TileSparseOperand":
        """The same operand with payload, scales and index tensors on
        ``device``."""
        return TileSparseOperand(
            self.payload.to(device),
            None if self.scales is None else self.scales.to(device),
            self.layout, self.indptr.to(device), self.indices.to(device))

    def __repr__(self) -> str:
        return self.layout.describe().replace("TileSparseLayout",
                                              "TileSparseOperand")


def is_sparse(w) -> bool:
    return isinstance(w, TileSparseOperand)
