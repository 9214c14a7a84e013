"""Deterministic synthetic token pipeline (own copy of
``repro.data.pipeline``, numpy only): every batch is a pure function of
(seed, step), so the two packages draw identical batches from one seed,
and a run restored at step N sees the same remaining stream."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticLM:
    """Zipf-ish synthetic token stream with next-token structure (a noisy
    affine map over token ids), so the loss falls during training."""

    def __init__(self, vocab: int, global_batch: int, seq_len: int,
                 seed: int = 0, extra_specs: Optional[Dict] = None):
        self.vocab = vocab
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = PipelineState(seed=seed, step=0)
        self.extra_specs = extra_specs or {}

    def snapshot(self) -> Dict:
        return dataclasses.asdict(self.state)

    def restore(self, snap: Dict):
        self.state = PipelineState(**snap)

    def _tokens(self, rng: np.random.Generator) -> np.ndarray:
        b, s, v = self.global_batch, self.seq_len, self.vocab
        base = rng.zipf(1.3, size=(b, 1)).clip(1, v - 1)
        steps = rng.integers(1, 7, size=(b, 1))
        noise = rng.integers(0, 3, size=(b, s + 1))
        pos = np.arange(s + 1)[None, :]
        return ((base + steps * pos + noise) % v).astype(np.int32)

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, self.state.step]))
        batch = {"tokens": self._tokens(rng)}
        for name, (shape, dtype) in self.extra_specs.items():
            batch[name] = rng.standard_normal(
                (self.global_batch,) + tuple(shape)).astype(dtype)
        self.state.step += 1
        return batch

    def host_slice(self, batch: Dict[str, np.ndarray], host_id: int = 0,
                   n_hosts: int = 1):
        """The per-host shard of the global batch."""
        per = self.global_batch // n_hosts
        return {k: v[host_id * per:(host_id + 1) * per]
                for k, v in batch.items()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                                torch.Tensor]:
    """A host batch as torch tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


class StaticBatch:
    """Device tensors at fixed addresses that take every host batch of one
    shape in place, for a step that reads its batch by address (a captured
    one: ``train.train_step.TrainStepGraph``).  Each batch goes through a
    host twin, pinned on the card, by a non-blocking copy on the current
    stream: the caller reads each step's result (which waits for the
    copy) before it fills the next batch."""

    def __init__(self, like: Dict[str, np.ndarray], device):
        device = torch.device(device)
        pin = device.type == "cuda"
        like = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in like.items()}
        self.host = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                     for k, t in like.items()}
        self.tensors = {k: torch.empty(t.shape, dtype=t.dtype, device=device)
                        for k, t in like.items()}

    def fill(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Copy ``batch`` into :attr:`tensors` (the same tensors every
        call) and return them."""
        if batch.keys() != self.tensors.keys():
            raise ValueError(f"batch holds {sorted(batch)}, the static one "
                             f"{sorted(self.tensors)}")
        for k, arr in batch.items():
            host = self.host[k]
            if tuple(arr.shape) != tuple(host.shape):
                raise ValueError(f"batch[{k!r}] has shape {arr.shape}, the "
                                 f"static one {tuple(host.shape)}")
            host.numpy()[...] = arr
            self.tensors[k].copy_(host, non_blocking=True)
        return self.tensors
