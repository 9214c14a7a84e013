"""Which weight leaves are GEMM operands (own copy of the leaf set of
``repro.core.quantization``).

``QUANT_LEAVES`` names the 2-D+ GEMM weights that ``packing/params.py``
packs; embeddings (gather-indexed), norms, gates and routers stay dense.
The static per-tensor ``{"q", "scale"}`` storage of the reference module is
not ported: the int8 policy quantizes per call (``core/policy.py``) and
``--pack`` stores per-tile payloads.
"""
QUANT_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ck", "cv", "cr",
    "wr", "wg", "w_x", "w_y", "w_out", "w_gate_r", "w_gate_i", "head",
})
