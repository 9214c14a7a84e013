"""Training step (port of ``repro.train.train_step``): gradients summed in
f32 over microbatches, then one AdamW update (in place) with the cosine
schedule.  :class:`TrainStepGraph` captures the step in one CUDA graph, the
port's counterpart of the reference's ``jax.jit(step_fn,
donate_argnums=(0, 1))``: the state is updated in place either way."""
from __future__ import annotations

import torch

from repro_torch.core.cuda_graphs import CapturedStep
from repro_torch.optim.adamw import (
    AdamWConfig, AdamWState, adamw_update, cosine_schedule, decay_mask,
    tree_leaves, tree_map,
)


def pick_microbatches(cfg, shape, ddp: int, budget_bytes: float = 4e9) -> int:
    """Smallest power-of-two microbatch count keeping per-device live
    activations (layer-boundary residuals under per-layer remat) under
    budget."""
    b_dev = max(1, shape.global_batch // ddp)
    resid = b_dev * shape.seq_len * cfg.d_model * 2 * max(1, cfg.n_layers)
    m = 1
    while m < b_dev and resid / m > budget_bytes:
        m *= 2
    # The count must divide the global batch and keep >= ddp rows each.
    while m > 1 and (shape.global_batch % m or shape.global_batch // m < ddp):
        m //= 2
    return max(1, m)


def _value_and_grad(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt_cfg: AdamWConfig, microbatches: int = 1,
                    total_steps: int = 100000, warmup: int = 500):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds device tensors with the global batch on
    axis 0, split into ``microbatches`` equal parts."""

    def train_step(params, opt_state: AdamWState, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                mb = {k: v.chunk(microbatches)[i] for k, v in batch.items()}
                l_i, g_i = _value_and_grad(model, params, mb)
                tree_map(lambda a, b: a.add_(b.float()), grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        lr_scale = cosine_schedule(opt_state.step, warmup=warmup,
                                   total=total_steps)
        params, opt_state, metrics = adamw_update(
            grads, opt_state, params, opt_cfg, decay_mask(params, model.cfg),
            lr_scale=lr_scale)
        metrics["loss"] = loss
        metrics["lr_scale"] = lr_scale
        return params, opt_state, metrics

    return train_step


class TrainStepGraph(CapturedStep):
    """``train_step(params, opt, batch)`` (:func:`make_train_step`)
    captured in one CUDA graph
    (:class:`~repro_torch.core.cuda_graphs.CapturedStep`).

    The graph reads and writes the parameters, the AdamW moments and step
    counter, and reads ``batch`` (a dict of device tensors), all at their
    captured addresses: the caller fills ``batch`` in place before each
    :meth:`replay`, which updates the state in place and returns the
    step's metrics (loss, grad norm, clip scale, lr scale) as static
    device tensors that the next replay overwrites.  The caller has run
    one eager step of the same shapes on ``stream`` first.  The backward
    runs on autograd's device thread, on the stream of each op's forward:
    the capture stream, so its launches land in the graph too.  A step
    that rebinds a leaf of the state instead of writing it in place
    raises (the graph would write a tensor nobody holds).
    """

    def __init__(self, train_step, params, opt: AdamWState, batch, *,
                 stream, pool):
        def addresses(*trees):
            return [t.data_ptr() for tree in trees
                    for t in tree_leaves(tree)]

        state = addresses(params, opt)
        super().__init__(lambda: train_step(params, opt, batch),
                         stream=stream, pool=pool,
                         held=(params, opt, batch))
        p_out, o_out, self.metrics = self.out
        self.out = self.metrics
        if state != addresses(p_out, o_out) or state != addresses(params,
                                                                  opt):
            raise RuntimeError("the train step rebound a leaf of the "
                               "parameters or the AdamW state during the "
                               "capture; a graph updates them in place")


def make_eval_step(model):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss_fn(params, batch)
    return eval_step
