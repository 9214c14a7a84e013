"""Tile-sparse operands (port of ``repro.sparse``): weight tiles that are
pruned on the (bk, bn) lattice are dropped from storage and from the
tile-sparse GEMM's walk (K3, ``kernels/csrc/mpgemm_sparse.cu``).

    sparsify_magnitude / sparsify_nm / sparsify_params
        |  TileSparseOperand (stored tiles + per-tile scales + layout
        |                     + device indptr / indices)
        v
    mp_dot / mp_dot_grouped (x, TileSparseOperand)
        v
    kernels/mpgemm.py  mpgemm_sparse(_grouped): K3 on the card, its plain
                       version on the CPU
"""
from repro_torch.sparse.layout import (
    SparseSchedule, TileSparseLayout, TileSparseOperand, build_schedule,
    is_sparse,
)
from repro_torch.sparse.params import (
    nm_for_sparsity, sparse_param_bytes, sparse_param_density,
    sparsify_params,
)
from repro_torch.sparse.sparsify import (
    build_payload, densify_operand, magnitude_mask, nm_mask,
    sparsify_magnitude, sparsify_nm, sparsify_with_mask, tile_scores,
)

__all__ = [
    "SparseSchedule", "TileSparseLayout", "TileSparseOperand",
    "build_payload", "build_schedule", "densify_operand", "is_sparse",
    "magnitude_mask", "nm_for_sparsity", "nm_mask", "sparse_param_bytes",
    "sparse_param_density", "sparsify_magnitude", "sparsify_nm",
    "sparsify_params", "sparsify_with_mask", "tile_scores",
]
