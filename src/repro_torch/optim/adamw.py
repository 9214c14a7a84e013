"""AdamW with global-norm clipping and decoupled weight decay (port of
``repro.optim.adamw``).

Parameters, gradients and both moments are nested dicts / lists of
tensors; the moments are f32.  :func:`adamw_update` updates the parameters,
the moments and the step counter IN PLACE (the reference returns new
trees): a checkpoint must copy them to the host before it hands them to a
background writer (``checkpoint.Checkpointer.save`` does), and a captured
step (``train.train_step.TrainStepGraph``) reads and writes each of them at
one address, so the step count, the bias corrections and the schedule move
on every replay.  Every scalar (step, norm, scale, learning rate) stays a
device tensor, so an update never waits on the host.

**Which leaves decay.**  The reference decays a leaf when ``p.ndim >= 2``,
and it stacks each unit's layers (and the encoder) along a leading axis,
so a layer's (d,) norm scale is a (L, d) leaf there and is decayed, while
the top-level ``final_norm`` (d,) is not.  The port keeps one dict per
layer; :func:`decay_mask` gives each leaf the rank its counterpart has in
the reference's stacked tree, so both decay the same leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import segment_pattern


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 0-d
    m: Any                   # like params (f32)
    v: Any                   # like params (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree):
    """The tensors of a nested dict / list, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def decay_mask(params, cfg):
    """A params-like tree of bools: does AdamW decay this leaf?  A leaf of
    a stacked layer (``segment_pattern``'s stack, every encoder layer)
    has one more axis in the reference, so it decays at rank >= 1; a tail
    layer's and a top-level leaf at rank >= 2."""
    unit, n_units, _ = segment_pattern(cfg.pattern)
    stacked_layers = len(unit) * n_units

    def ranks(node, extra):
        return tree_map(lambda p: p.dim() + extra >= 2, node)

    out = {}
    for name, node in params.items():
        if name == "layers":
            out[name] = [ranks(layer, int(i < stacked_layers))
                         for i, layer in enumerate(node)]
        elif name == "encoder":
            out[name] = [ranks(layer, 1) for layer in node]
        else:
            out[name] = ranks(node, 0)
    return out


def adamw_init(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares (f32 0-d)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 decay, lr_scale=1.0):
    """-> (params, state, metrics): the same trees, the parameters, the
    moments and ``state.step`` updated in place.  ``decay`` is
    :func:`decay_mask`'s tree; ``lr_scale`` a float or a device tensor
    (:func:`cosine_schedule`)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = state.step.add_(1).float()
    b1c = 1.0 - cfg.b1 ** stepf          # a Python base: no host copy
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * lr_scale
    for g, m, v, p, dk in zip(tree_leaves(grads), tree_leaves(state.m),
                              tree_leaves(state.v), tree_leaves(params),
                              tree_leaves(decay)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        if dk:
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, state, metrics


def cosine_schedule(step, *, base_lr=1.0, warmup=100, total=10000,
                    min_frac=0.1):
    """Multiplicative lr scale in [min_frac, 1]: linear warm-up, then a
    cosine to ``min_frac`` at ``total`` (``step`` a device tensor)."""
    step = step.float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * warm * cos
