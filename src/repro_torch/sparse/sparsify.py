"""Tile sparsifiers and payload build / densify (port of
``repro.sparse.sparsify``).

Sparsification is an offline weight transformation, run once at load
time.  Two pattern families, both scored by the per-tile Frobenius norm on
the (bk, bn) lattice (:func:`tile_scores`, f64 on the weight's device):

* :func:`magnitude_mask` -- keep the top ``density`` fraction of tiles per
  group (a budget of ``ceil(density * nkb * nnb)``, stable order);
* :func:`nm_mask` -- in every run of ``m_block`` k-tiles of one output
  column keep the ``n_keep`` strongest.

Both drop exactly-zero tiles (``prune_zero``).  The masks run on the host
over the (g, nkb, nnb) scores, which are small; the payload is built on
the weight's device: :func:`build_payload` packs the whole weight with
``pack_operand`` (K6 on the card, its plain version on the CPU), gathers
the stored tiles (and their int8 scales) and appends the zero tile, so the
bytes are the reference's (its sparse int8 codec is the packer's).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.codecs import dtype_name, torch_dtype
from repro_torch.packing.pack import pack_operand
from repro_torch.sparse.layout import TileSparseLayout, TileSparseOperand


def _core_dims(w, *, trans_w: bool, grouped: bool) -> Tuple[int, int, int]:
    shape = w.shape[1:] if grouped else w.shape
    if len(shape) != 2:
        raise ValueError(f"sparsify expects a 2-D (or grouped 3-D) operand, "
                         f"got {tuple(w.shape)}")
    k, n = (shape[1], shape[0]) if trans_w else shape
    return k, n, (w.shape[0] if grouped else 1)


def tile_scores(w: torch.Tensor, blocks: Tuple[int, int], *,
                trans_w: bool = False) -> torch.Tensor:
    """Per-tile Frobenius norms on the (bk, bn) lattice: (g, nkb, nnb) f64
    on ``w``'s device."""
    bk, bn = blocks
    grouped = w.dim() == 3
    k, n, g = _core_dims(w, trans_w=trans_w, grouped=grouped)
    bk, bn = min(bk, k), min(bn, n)
    arr = w.to(torch.float64)
    if not grouped:
        arr = arr[None]
    if trans_w:
        arr = arr.transpose(-1, -2)
    nkb, nnb = -(-k // bk), -(-n // bn)
    arr = F.pad(arr, (0, nnb * bn - n, 0, nkb * bk - k))
    t = arr.reshape(g, nkb, bk, nnb, bn)
    return (t * t).sum(dim=(2, 4)).sqrt()


def _host(scores) -> np.ndarray:
    if isinstance(scores, torch.Tensor):
        return scores.cpu().numpy()
    return np.asarray(scores)


def _keep_to_structure(keep) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(g, nkb, nnb) bool mask -> column-major BSR (indptr, indices)."""
    keep = np.asarray(keep, bool)
    g, nkb, nnb = keep.shape
    cols = keep.transpose(0, 2, 1).reshape(g * nnb, nkb)
    indptr = np.concatenate([[0], np.cumsum(cols.sum(axis=1))])
    return tuple(indptr.tolist()), tuple(np.nonzero(cols)[1].tolist())


def _stored_linear_idx(layout: TileSparseLayout) -> np.ndarray:
    """(nnz,) indices of the stored tiles into the flat (g * nkb * nnb)
    lattice, in payload (column-major) order."""
    nkb, nnb = layout.nkb, layout.nnb
    counts = np.diff(np.asarray(layout.indptr, np.int64))
    col = np.repeat(np.arange(layout.g * nnb, dtype=np.int64), counts)
    gi, j = np.divmod(col, nnb)
    return (gi * nkb + np.asarray(layout.indices, np.int64)) * nnb + j


def build_payload(w: torch.Tensor, layout: TileSparseLayout):
    """Stored tiles (+ the trailing zero tile) of ``w`` under ``layout``:
    ``(payload (nnz + 1, bk, bn), scales (nnz + 1, 1) f32 | None)`` on
    ``w``'s device.  An int8 payload quantizes each stored tile with its
    own scale; the zero tile's scale is 1.0."""
    packed = pack_operand(w, (layout.bk, layout.bn), trans_w=layout.trans_w,
                          dtype=layout.dtype)
    dev, bk, bn = w.device, layout.bk, layout.bn
    idx = torch.from_numpy(_stored_linear_idx(layout)).to(dev)
    stored = packed.payload.reshape(-1, bk, bn)[idx]
    payload = torch.cat([stored, stored.new_zeros(1, bk, bn)])
    if not layout.per_tile_scales:
        return payload, None
    scales = packed.scales.reshape(-1)[idx]
    scales = torch.cat([scales, scales.new_ones(1)]).reshape(-1, 1)
    return payload, scales


def densify_operand(p: TileSparseOperand, *, dtype=None) -> torch.Tensor:
    """The dense (k, n) ((g, k, n) when grouped) weight with zeros at the
    pruned tiles, in plain torch ops on the payload's device.  int8
    payloads dequantize per stored tile; ``dtype`` defaults to the payload
    dtype (int8: the source dtype)."""
    layout = p.layout
    if dtype is None:
        dtype = layout.orig_dtype if layout.per_tile_scales else layout.dtype
    nnz, dev = layout.nnz, p.payload.device
    tiles = p.payload[:nnz].float()
    if p.scales is not None:
        tiles = tiles * p.scales[:nnz].reshape(-1, 1, 1)
    lattice = torch.zeros(layout.ntiles, layout.bk, layout.bn,
                          dtype=torch.float32, device=dev)
    lattice[torch.from_numpy(_stored_linear_idx(layout)).to(dev)] = tiles
    full = lattice.reshape(
        layout.g, layout.nkb, layout.nnb, layout.bk, layout.bn
    ).permute(0, 1, 3, 2, 4).reshape(
        layout.g, layout.nkb * layout.bk, layout.nnb * layout.bn
    )[:, :layout.k, :layout.n].to(torch_dtype(dtype))
    return full if layout.g != 1 else full[0]


def payload_cotangent(dense_ct: torch.Tensor,
                      layout: TileSparseLayout) -> torch.Tensor:
    """Mask a dense weight cotangent to the stored tiles (the sparse
    weight's gradient rule): the stored tiles of ``dense_ct`` in payload
    order, then a zero cotangent for the trailing zero tile, a structural
    constant.  ``dense_ct`` is (k, n) or (g, k, n) with the transpose
    resolved (the backward GEMMs resolve it), so the layout's source
    transpose is not applied again.  Plain torch ops on ``dense_ct``'s
    device and in its dtype, as the reference's XLA gather."""
    bk, bn, nkb, nnb = layout.bk, layout.bn, layout.nkb, layout.nnb
    w = dense_ct.reshape(layout.g, layout.k, layout.n)
    w = F.pad(w, (0, nnb * bn - layout.n, 0, nkb * bk - layout.k))
    tiles = w.reshape(layout.g, nkb, bk, nnb, bn).permute(
        0, 1, 3, 2, 4).reshape(-1, bk, bn)
    idx = torch.from_numpy(_stored_linear_idx(layout)).to(dense_ct.device)
    stored = tiles[idx]
    return torch.cat([stored, stored.new_zeros(1, bk, bn)])


# --- pattern -> operand ------------------------------------------------------

def sparsify_with_mask(w: torch.Tensor, blocks: Tuple[int, int], keep, *,
                       trans_w: bool = False, dtype=None
                       ) -> TileSparseOperand:
    """A :class:`TileSparseOperand` from an explicit (nkb, nnb) -- or
    (g, nkb, nnb) for a grouped operand -- tile keep-mask over the
    lattice of the transpose-resolved weight."""
    bk, bn = int(blocks[0]), int(blocks[1])
    grouped = w.dim() == 3
    k, n, g = _core_dims(w, trans_w=trans_w, grouped=grouped)
    bk, bn = min(bk, k), min(bn, n)
    keep = np.asarray(_host(keep), bool)
    if keep.ndim == 2:
        keep = keep[None]
    nkb, nnb = -(-k // bk), -(-n // bn)
    if keep.shape != (g, nkb, nnb):
        raise ValueError(
            f"keep mask shape {keep.shape} != tile lattice {(g, nkb, nnb)}")
    indptr, indices = _keep_to_structure(keep)
    layout = TileSparseLayout(
        k=k, n=n, bk=bk, bn=bn, dtype=dtype_name(dtype or w.dtype),
        orig_dtype=dtype_name(w.dtype), indptr=indptr, indices=indices,
        trans_w=trans_w, g=g)
    payload, scales = build_payload(w, layout)
    return TileSparseOperand(payload, scales, layout)


def magnitude_mask(scores, density: float, *,
                   prune_zero: bool = True) -> np.ndarray:
    """Top-``density`` tile mask per group from (g, nkb, nnb) scores."""
    if not 0.0 <= density <= 1.0:
        raise ValueError(f"density must be in [0, 1], got {density}")
    scores = _host(scores)
    g, nkb, nnb = scores.shape
    budget = math.ceil(density * nkb * nnb)
    keep = np.zeros(scores.shape, dtype=bool)
    for gi in range(g):
        flat = scores[gi].ravel()
        order = np.argsort(-flat, kind="stable")[:budget]
        m = np.zeros(flat.shape, bool)
        m[order] = True
        if prune_zero:
            m &= flat > 0.0
        keep[gi] = m.reshape(nkb, nnb)
    return keep


def nm_mask(scores, n_keep: int, m_block: int, *,
            prune_zero: bool = True) -> np.ndarray:
    """N:M structured mask over the k-tile axis from (g, nkb, nnb)
    scores."""
    if not 0 < n_keep <= m_block:
        raise ValueError(f"need 0 < n_keep <= m_block, got "
                         f"{n_keep}:{m_block}")
    scores = _host(scores)
    g, nkb, nnb = scores.shape
    keep = np.zeros(scores.shape, dtype=bool)
    for gi in range(g):
        for j in range(nnb):
            col = scores[gi, :, j]
            for lo in range(0, nkb, m_block):
                chunk = col[lo:lo + m_block]
                order = np.argsort(-chunk, kind="stable")[:n_keep]
                m = np.zeros(chunk.shape, bool)
                m[order] = True
                if prune_zero:
                    m &= chunk > 0.0
                keep[gi, lo:lo + m_block, j] = m
    return keep


def sparsify_magnitude(w: torch.Tensor, blocks: Tuple[int, int], *,
                       density: float, trans_w: bool = False, dtype=None,
                       prune_zero: bool = True) -> TileSparseOperand:
    """Magnitude tile pruning: keep the top ``density`` fraction of (bk, bn)
    tiles by Frobenius norm (per group for a grouped operand)."""
    scores = tile_scores(w, blocks, trans_w=trans_w)
    keep = magnitude_mask(scores, density, prune_zero=prune_zero)
    return sparsify_with_mask(w, blocks, keep, trans_w=trans_w, dtype=dtype)


def sparsify_nm(w: torch.Tensor, blocks: Tuple[int, int], *,
                n_keep: int = 2, m_block: int = 4, trans_w: bool = False,
                dtype=None, prune_zero: bool = True) -> TileSparseOperand:
    """Structured N:M tile pruning along K: every ``m_block`` consecutive
    k-tiles of an output column keep their ``n_keep`` strongest."""
    scores = tile_scores(w, blocks, trans_w=trans_w)
    keep = nm_mask(scores, n_keep, m_block, prune_zero=prune_zero)
    return sparsify_with_mask(w, blocks, keep, trans_w=trans_w, dtype=dtype)
