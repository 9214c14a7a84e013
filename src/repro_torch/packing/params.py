"""Pack a model's parameter dict at load time (port of
``repro.packing.params``; the port's per-layer dict has no stacked-layer
axis, so a leaf is a 2-D weight or a 3-D MoE expert stack).

``pack_params`` replaces every eligible GEMM weight (``QUANT_LEAVES``: the
projections and the untied head; embeddings, norms and MoE routers stay
dense) with its :class:`~repro_torch.packing.layout.PackedOperand`, grouped
for the (E, d, f) expert stacks of ``MOE_GROUPED_LEAVES``:

    policy fp32 / bf16 / bf16_serve  ->  float payload in the compute dtype
    policy int8                      ->  int8 payload + per-tile scales
    pack_format int8 / int4 / fp8    ->  that codec, under any policy

**Blocks.**  The reference takes (bk, bn) from its TPU block planner, seeded
with the serve CLI's ``m_hint``; it gives 2048 x 2048 at every phi3-mini
shape, where K = 3072 would pad to 4096.  The Hopper planner
(``core/blocking.py``) pins a packed operand's (bk, bn) to the payload tile
K2's wgmma design reads, ``WGMMA_PAYLOAD_TILE`` (128 x 128) clamped to the
extent, whatever M is (M moves only bm, which each launch's plan picks):
:func:`default_blocks`, with no ``m_hint``.  ``blocks=`` overrides it, so
that a parity test can hand both packages the same blocks.

**Cache.**  With a packed-weight cache (``cache=``, default the process's
``packing/cache.py::get_pack_cache()``, which is off unless
``REPRO_TORCH_PACK_CACHE`` names a directory) every weight goes through
``get_or_pack`` under its path in the parameter tree (``layers/3/attn/wq``;
``prefix`` gives the path of the subtree passed in): a hit launches no
packer.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.codecs import (
    CODECS, canonical_payload_dtype, get_codec,
)
from repro_torch.core.constants import WGMMA_PAYLOAD_TILE
from repro_torch.core.policy import get_policy
from repro_torch.core.quantization import QUANT_LEAVES
from repro_torch.packing.cache import PackedWeightCache, get_pack_cache
from repro_torch.packing.layout import PackedOperand
from repro_torch.packing.pack import pack_operand

# Leaves that are grouped (expert-batched) when 3-D.
MOE_GROUPED_LEAVES = frozenset({"w_gate", "w_up", "w_down"})

def default_blocks(k: int, n: int) -> Tuple[int, int]:
    """The payload tile the Hopper planner pins for a (k, n) weight:
    ``WGMMA_PAYLOAD_TILE``, clamped to the extent."""
    bk, bn = WGMMA_PAYLOAD_TILE
    return min(bk, k), min(bn, n)


def payload_dtype(policy, pack_format: Optional[str] = None) -> str:
    """The payload dtype ``pack_params`` stores for ``policy``."""
    if pack_format is not None:
        dtype = canonical_payload_dtype(pack_format)
        if get_codec(dtype) is None:
            raise ValueError(
                f"pack_format {pack_format!r} is not a quantized payload "
                f"codec; valid: {sorted(CODECS)} (or their aliases)")
        return dtype
    policy = get_policy(policy)
    return "int8" if policy.quantized else policy.compute_dtype


def pack_params(params, *, policy="bf16", pack_format: Optional[str] = None,
                leaves: Optional[Sequence[str]] = None,
                blocks: Optional[Callable[[int, int],
                                          Tuple[int, int]]] = None,
                cache: Optional[PackedWeightCache] = None,
                prefix: Tuple = ()):
    """A copy of the (nested dict / list) ``params`` with eligible 2-D float
    GEMM weights and 3-D expert stacks packed (one grouped pack launch per
    stack); ``blocks(k, n) -> (bk, bn)`` defaults to
    :func:`default_blocks`.  Run it on the f32 draw: per-tile amax over
    bf16-rounded values gives other payload bytes.  ``cache`` and
    ``prefix``: the module docstring."""
    dtype = payload_dtype(policy, pack_format)
    eligible = frozenset(leaves) if leaves is not None else QUANT_LEAVES
    blocks = blocks or default_blocks
    cache = cache if cache is not None else get_pack_cache()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        name = next((p for p in reversed(path) if isinstance(p, str)), None)
        if (name not in eligible or not isinstance(node, torch.Tensor)
                or not node.is_floating_point()):
            return node
        if node.dim() != 2 and not (node.dim() == 3
                                    and name in MOE_GROUPED_LEAVES):
            return node
        k, n = node.shape[-2:]
        if cache is None:
            return pack_operand(node, blocks(k, n), dtype=dtype)
        return cache.get_or_pack("/".join(map(str, path)), node, blocks(k, n),
                                 dtype=dtype)

    return walk(params, tuple(prefix))


def packed_param_bytes(params) -> int:
    """Total bytes of packed payloads and scales in a parameter tree."""
    if isinstance(params, PackedOperand):
        return params.nbytes
    if isinstance(params, dict):
        return sum(packed_param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(packed_param_bytes(v) for v in params)
    return 0
