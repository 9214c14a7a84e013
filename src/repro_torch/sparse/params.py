"""Sparsify a model's parameter dict at load time (port of
``repro.sparse.params``).

``sparsify_params`` replaces every eligible GEMM weight (``QUANT_LEAVES``:
the projections and an untied head; embeddings, norms and MoE routers stay
dense) with its :class:`~repro_torch.sparse.layout.TileSparseOperand`,
grouped for the (E, d, f) expert stacks of ``MOE_GROUPED_LEAVES``:

    policy fp32 / bf16 / bf16_serve  ->  float payload in the compute dtype
    policy int8                      ->  int8 payload + per-tile scales

**Shared patterns.**  The reference stacks the layers of each position of
its scan unit (and the whole encoder) along a leading axis, and one leaf
has one static layout: the tile scores are averaged over that axis, so all
the layers of a stack share one pattern.  The port keeps a dict per layer
and rebuilds the same groups from the config: layer ``u * len(unit) + p``
of the ``segment_pattern`` stack joins group ``p``, every encoder layer
joins one group, and each tail layer and the head stand alone.

Run it on the f32 draw: the scores and the int8 scales come from the f32
values.  Scores are summed on the weights' device in f64, layer by layer
in layer order, then divided by the group's size (the reference's numpy
mean over the stacked axis); the masks run on the host.

**Blocks.**  ``blocks=(bk, bn)`` sets the lattice; by default the payload
tile the Hopper planner pins for K3's wgmma design (``core/blocking.py``),
128 x 128 clamped to each weight's extent (``packing/params.py::
default_blocks``; the reference's ``m_hint`` moves no Hopper block).

**Cache.**  With a packed-weight cache (``cache=``, default
``packing/cache.py::get_pack_cache()``) each weight's payload goes through
``get_or_build`` under its path in the tree after the pattern step, so the
key carries the pattern's digest (the layout tag): a hit builds no
payload and launches no packer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.codecs import dtype_name
from repro_torch.core.quantization import (
    QUANT_LEAVES, copy_tree, group_key, layer_groups, set_leaf, tree_leaves,
)
from repro_torch.packing.cache import PackedWeightCache, get_pack_cache
from repro_torch.packing.params import (
    MOE_GROUPED_LEAVES, default_blocks, payload_dtype,
)
from repro_torch.sparse.layout import TileSparseLayout, TileSparseOperand
from repro_torch.sparse.sparsify import (
    _core_dims, _keep_to_structure, build_payload, magnitude_mask, nm_mask,
    tile_scores,
)

METHODS = ("magnitude", "nm")

# The serve CLI's N:M rule keeps n_keep of every M_BLOCK k-tiles.
M_BLOCK = 4


def nm_for_sparsity(sparsity: float) -> Tuple[int, int]:
    """(n_keep, m_block) of a requested prune fraction, as the reference's
    serve CLI derives it: the level rounds to the NEAREST multiple of
    1/4, keeping at least one tile of every four."""
    return max(1, round((1.0 - sparsity) * M_BLOCK)), M_BLOCK


def _eligible(path, leaf) -> Optional[bool]:
    """None if the leaf stays dense, else whether it is grouped."""
    name = path[-1]
    if name not in QUANT_LEAVES or not leaf.is_floating_point():
        return None
    if leaf.dim() == 2:
        return False
    if leaf.dim() == 3 and name in MOE_GROUPED_LEAVES:
        return True
    return None


def _shared_layout(members: Sequence[torch.Tensor], grouped: bool, blocks,
                   *, dtype: str, method: str, density: float,
                   nm: Tuple[int, int]) -> TileSparseLayout:
    """One layout for every weight of a sharing group: the mean of their
    tile scores, masked by ``method``."""
    k, n, g = _core_dims(members[0], trans_w=False, grouped=grouped)
    bk, bn = blocks if blocks is not None else default_blocks(k, n)
    bk, bn = min(int(bk), k), min(int(bn), n)
    total = None
    for w in members:
        s = tile_scores(w, (bk, bn))
        total = s if total is None else total + s
    scores = total / len(members)
    if method == "magnitude":
        keep = magnitude_mask(scores, density)
    else:
        keep = nm_mask(scores, *nm)
    indptr, indices = _keep_to_structure(keep)
    return TileSparseLayout(k=k, n=n, bk=bk, bn=bn, dtype=dtype,
                            orig_dtype=dtype_name(members[0].dtype),
                            indptr=indptr, indices=indices, g=g)


def sparsify_params(params, *, cfg, density: float = 0.5,
                    method: str = "magnitude", nm: Tuple[int, int] = (2, 4),
                    policy="bf16",
                    blocks: Optional[Tuple[int, int]] = None,
                    cache: Optional[PackedWeightCache] = None):
    """A copy of ``params`` with every eligible GEMM weight replaced by its
    tile-sparse operand, built on the weight's device (one K6 pack launch
    per weight on the card).

    ``density`` is the kept-tile fraction of the magnitude method;
    ``method="nm"`` keeps ``nm = (n_keep, m_block)`` of every ``m_block``
    k-tiles of each output column instead.  ``cfg`` (the model's
    ``ArchConfig``) gives the sharing groups of ``params["layers"]``;
    ``cache``: the module docstring.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS}")
    dtype = payload_dtype(policy)
    cache = cache if cache is not None else get_pack_cache()
    shared = layer_groups(len(params.get("layers", ())), cfg)
    groups: Dict[Tuple, List[Tuple[Tuple, torch.Tensor]]] = {}
    kinds: Dict[Tuple, bool] = {}
    for path, leaf in tree_leaves(params):
        grouped = _eligible(path, leaf)
        if grouped is None:
            continue
        key = group_key(path, shared)
        groups.setdefault(key, []).append((path, leaf))
        kinds[key] = grouped
    out = copy_tree(params)
    for key, members in groups.items():
        weights = [w for _, w in members]
        shapes = {tuple(w.shape) for w in weights}
        if len(shapes) != 1:
            raise ValueError(f"the weights sharing a pattern at {key} have "
                             f"shapes {sorted(shapes)}")
        layout = _shared_layout(weights, kinds[key], blocks, dtype=dtype,
                                method=method, density=density, nm=nm)
        indptr = indices = None
        for path, w in members:
            if cache is None:
                payload, scales = build_payload(w, layout)
            else:
                op = cache.get_or_build(
                    "/".join(map(str, path)), w, layout,
                    lambda: TileSparseOperand(*build_payload(w, layout),
                                              layout))
                payload, scales = op.payload, op.scales
            op = TileSparseOperand(payload, scales, layout, indptr, indices)
            indptr, indices = op.indptr, op.indices   # one copy per group
            set_leaf(out, path, op)
    return out


def _sparse_leaves(node, path=()):
    """(path, operand) for every sparse operand of a nested dict / list."""
    if isinstance(node, TileSparseOperand):
        yield path, node
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _sparse_leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _sparse_leaves(v, path + (i,))


def sparse_param_bytes(params) -> int:
    """Total payload and scale bytes of the sparse operands in a tree."""
    return sum(op.nbytes for _, op in _sparse_leaves(params))


def sparse_param_density(params, cfg) -> float:
    """nnz over the dense tile count of the sparse operands (1.0 when there
    is none), each group of layers that shares one pattern counted once --
    the reference's one stacked leaf (``sparsify_params`` builds the same
    groups from ``cfg``, the model's ``ArchConfig``)."""
    shared = layer_groups(len(params.get("layers", ())), cfg)
    layouts = {}
    for path, op in _sparse_leaves(params):
        layouts.setdefault(group_key(path, shared), op.layout)
    ntiles = sum(lay.ntiles for lay in layouts.values())
    return (sum(lay.nnz for lay in layouts.values()) / ntiles if ntiles
            else 1.0)
