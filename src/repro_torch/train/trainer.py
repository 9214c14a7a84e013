"""Training controller (port of ``repro.train.trainer``, one device): the
step function, the synthetic pipeline, checkpointing and the straggler
detector.  A step's time ends when the loss is read on the host (the
reference's ``block_until_ready``)."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpointing import Checkpointer
from repro_torch.data.pipeline import SyntheticLM, device_batch
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    microbatches: int = 1
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    def __init__(self, model, shape, tcfg: TrainerConfig, mesh=None,
                 seed: int = 0):
        if mesh is not None:
            raise NotImplementedError(
                "sharded training (a mesh) is not ported yet")
        self.model = model
        self.cfg = model.cfg
        self.tcfg = tcfg
        self.seed = seed
        extra = {}
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

    def run(self, params=None, opt=None, start_step: int = 0):
        if params is None:
            params, opt = self.init_state()
        dev = self.model.device
        for step in range(start_step, self.tcfg.steps):
            batch = device_batch(self.pipeline.next_batch(), dev)
            t0 = time.perf_counter()
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
            if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                self.save(step + 1, params, opt, blocking=False)
        if self.ckpt:
            self.ckpt.wait()
        return params, opt
