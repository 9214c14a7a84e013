"""Training controller (port of ``repro.train.trainer``, one device): the
step function, the synthetic pipeline, checkpointing and the straggler
detector.  A step's time ends when the loss is read on the host (the
reference's ``block_until_ready``).

On the card the step runs in a CUDA graph, as the reference jits it: the
first step of :meth:`Trainer.run` runs eagerly on the trainer's own stream,
then :class:`~repro_torch.train.train_step.TrainStepGraph` captures it and
every later step copies its batch into the graph's static one and replays.
``Trainer(cuda_graphs=False)`` keeps the eager loop."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.core.cuda_graphs import pool_bytes
from repro_torch.data.pipeline import StaticBatch, SyntheticLM, device_batch
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainStepGraph, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    """``cuda_graphs``: capture the training step in one CUDA graph in
    :meth:`run` (``graph``); ``None`` means on for a CUDA model and off
    for a CPU one, ``True`` on a CPU model raises."""

    def __init__(self, model, shape, tcfg: TrainerConfig, mesh=None,
                 seed: int = 0, cuda_graphs: Optional[bool] = None):
        if mesh is not None:
            raise NotImplementedError(
                "sharded training (a mesh) is not ported yet")
        on_card = torch.device(model.device).type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a CUDA model, this one "
                             f"is on {model.device}")
        self.cuda_graphs = on_card if cuda_graphs is None else cuda_graphs
        self.graph: Optional[TrainStepGraph] = None
        self._pool = None
        self.model = model
        self.cfg = model.cfg
        self.tcfg = tcfg
        self.seed = seed
        extra = {}
        if self.cfg.family == "vlm":
            extra["image_embeds"] = ((self.cfg.n_image_tokens,
                                      self.cfg.d_model), "float32")
        if self.cfg.family == "audio":
            extra["audio_embeds"] = ((self.cfg.encoder_seq,
                                      self.cfg.d_model), "float32")
        self.pipeline = SyntheticLM(self.cfg.vocab, shape.global_batch,
                                    shape.seq_len, seed=seed,
                                    extra_specs=extra)
        self.step_fn = make_train_step(model, tcfg.opt,
                                       microbatches=tcfg.microbatches,
                                       total_steps=tcfg.steps)
        self.ckpt = (Checkpointer(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.detector = StragglerDetector()
        self.metrics_log = []

    # -- state ------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None):
        """f32 master parameters drawn on the model's device, and a fresh
        AdamW state."""
        seed = self.seed if seed is None else seed
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        params = self.model.init_train(gen)
        return params, adamw_init(params)

    def save(self, step: int, params, opt, blocking=True):
        if self.ckpt is None:
            return
        self.ckpt.save(step, {"params": params, "opt": opt},
                       extra={"pipeline": self.pipeline.snapshot()},
                       blocking=blocking)

    def restore(self, params_like, opt_like, step: Optional[int] = None):
        tree, manifest = self.ckpt.restore(
            {"params": params_like, "opt": opt_like}, step=step)
        self.pipeline.restore(manifest["extra"]["pipeline"])
        return tree["params"], tree["opt"], manifest["step"]

    # -- loop ----------------------------------------------------------------

    def graph_pool_bytes(self) -> int:
        """Bytes of the card's memory the captured step's pool holds."""
        return pool_bytes(self._pool)

    def run(self, params=None, opt=None, start_step: int = 0):
        """Train from ``start_step`` to ``tcfg.steps``; -> (params, opt),
        the trees it was given, updated in place.  With ``cuda_graphs``
        every step runs on a stream of the trainer's own: the first
        eagerly, then the step over these trees is captured (``graph``)
        and replayed for every later one; the caller's stream waits for
        the trainer's before this returns."""
        if params is None:
            params, opt = self.init_state()
        dev = self.model.device
        self.graph, stream, static = None, None, None
        if self.cuda_graphs:
            stream = torch.cuda.Stream(dev)
            # The state was made on the current stream.
            stream.wait_stream(torch.cuda.current_stream(dev))
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(stream):
            for step in range(start_step, self.tcfg.steps):
                host = self.pipeline.next_batch()
                if self.cuda_graphs:
                    if static is None:
                        static = StaticBatch(host, dev)
                    batch = static.fill(host)
                else:
                    batch = device_batch(host, dev)
                t0 = time.perf_counter()
                if self.graph is not None:
                    metrics = self.graph.replay()
                else:
                    params, opt, metrics = self.step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                verdict = self.detector.observe(dt)
                row = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "time_s": dt, "straggler": verdict}
                self.metrics_log.append(row)
                if step % self.tcfg.log_every == 0:
                    print(f"[train] step={step} loss={row['loss']:.4f} "
                          f"gnorm={row['grad_norm']:.3f} {dt * 1e3:.0f}ms",
                          flush=True)
                if (self.cuda_graphs and self.graph is None
                        and step + 1 < self.tcfg.steps):
                    self.graph = TrainStepGraph(self.step_fn, params, opt,
                                                batch, stream=stream,
                                                pool=self._pool)
                if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                    self.save(step + 1, params, opt, blocking=False)
        if stream is not None:
            torch.cuda.current_stream(dev).wait_stream(stream)
        if self.ckpt:
            self.ckpt.wait()
        return params, opt
