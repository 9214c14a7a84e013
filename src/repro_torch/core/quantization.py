"""Static (offline) int8 weight storage (port of
``repro.core.quantization``).

``quantize_params`` rewrites every eligible GEMM weight as the reference's
own ``{"q": int8, "scale": f32 0-d}`` dict; ``core.gemm.mp_dot`` and
``mp_dot_grouped`` dequantize such a dict before the GEMM (under the int8
policy to f32, which is then quantized per call like any f32 weight; else
to the compute dtype).  ``QUANT_LEAVES`` names the eligible leaves, which
``packing/params.py`` and ``sparse/params.py`` also transform; embeddings
(gather-indexed), norms, gates and routers stay as they are.

**Sharing groups.**  The reference quantizes each leaf of its stacked
parameter tree once, so one scale covers every layer of a ``stack[p]``
unit position, and the whole encoder stack likewise; each tail layer and
the head have their own.  The port keeps a dict per layer and rebuilds the
same groups from the config (:func:`layer_groups`, :func:`group_key`;
``sparsify_params`` shares its tile patterns over the same groups): a
group's scale comes from the largest |w| over all its members, so every
``q`` has the reference's bits.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import segment_pattern

QUANT_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "ck", "cv", "cr",
    "wr", "wg", "w_x", "w_y", "w_out", "w_gate_r", "w_gate_i", "head",
})


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as an IEEE division by a tensor (a
    Python-scalar divisor on a CUDA tensor would be a multiply by its
    reciprocal, which rounds differently)."""
    return amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)


def _quantize_with(w: torch.Tensor, scale: torch.Tensor) -> Dict[str, Any]:
    q = torch.round(w.float() / scale).clamp(-127, 127)
    return {"q": q.to(torch.int8), "scale": scale.float()}


def quantize_tensor(w: torch.Tensor) -> Dict[str, Any]:
    """``{"q", "scale"}`` of one tensor: f32 amax, ``scale = max(amax,
    1e-8) / 127`` and ``q = clip(round(w / scale), -127, 127)`` rounding
    half to even -- the bits of ``core/policy.py::quantize_per_tensor``."""
    return _quantize_with(w, _scale_of(w.float().abs().amax()))


def dequantize_tensor(wd: Dict[str, Any], dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """``q · scale`` in f32, then cast to ``dtype``: one elementwise op
    (the product is taken in f32 and rounded once on the store), so a
    served step reads the int8 weight and writes ``dtype`` with no f32
    copy between."""
    q = wd["q"]
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, wd["scale"], out=out)


def layer_groups(n_layers: int, cfg) -> List[Tuple]:
    """The sharing group of each entry of ``params["layers"]``: layer
    ``u * len(unit) + p`` of the ``segment_pattern`` stack joins
    ``("stack", p)``, each tail layer stands alone."""
    unit, n_units, _ = segment_pattern(cfg.pattern)
    stacked = n_units * len(unit)
    return [("stack", i % len(unit)) if i < stacked else ("tail", i)
            for i in range(n_layers)]


def group_key(path: Tuple, groups: List[Tuple]) -> Tuple:
    """The key a leaf at ``path`` shares with the reference's stacked leaf:
    a layer's index replaced by its group, every encoder layer's dropped."""
    if path[0] == "layers":
        return ("layers", groups[path[1]]) + path[2:]
    if path[0] == "encoder":
        return ("encoder",) + path[2:]
    return path


def tree_leaves(node, path=()):
    """(path, tensor) for every tensor of a nested dict / list."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from tree_leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from tree_leaves(v, path + (i,))
    elif isinstance(node, torch.Tensor):
        yield path, node


def copy_tree(node):
    """The nested dicts and lists of ``node`` copied, its leaves shared."""
    if isinstance(node, dict):
        return {k: copy_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(copy_tree(v) for v in node)
    return node


def set_leaf(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def quantize_params(params, *, cfg):
    """A copy of ``params`` with every float GEMM weight of rank >= 2
    named in ``QUANT_LEAVES`` as an int8 ``{"q", "scale"}`` dict, one
    scale per sharing group (module docstring); ``cfg`` is the model's
    ``ArchConfig``.  Run it on the f32 draw (or the bf16 weights the
    reference would quantize): the amax is taken in f32 over the values
    given."""
    groups = layer_groups(len(params.get("layers", ())), cfg)
    members: Dict[Tuple, List[Tuple[Tuple, torch.Tensor]]] = {}
    for path, leaf in tree_leaves(params):
        if (path[-1] in QUANT_LEAVES and leaf.dim() >= 2
                and leaf.is_floating_point()):
            members.setdefault(group_key(path, groups), []).append(
                (path, leaf))
    out = copy_tree(params)
    for group in members.values():
        amax = torch.stack([w.float().abs().amax() for _, w in group]).amax()
        scale = _scale_of(amax)
        for path, w in group:
            set_leaf(out, path, _quantize_with(w, scale))
    return out
