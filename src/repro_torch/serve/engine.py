"""Serving engine: continuous batching over a paged KV cache, and the
deprecated wave engine (port of ``repro.serve.engine``).

  * ``add_request()`` queues work; ``step()`` runs ONE forward — a pure
    decode step (chunk width 1) or, when a prompt is still being
    prefilled, a mixed chunked-prefill step where decode rows ride along
    with one valid column — and returns the requests that finished;
  * ``generate()`` adds everything and steps until drained, returning
    ``{uid: tokens}``.

KV lives in fixed-size pages (``serve/kv_cache.py``): admission allocates
pages for the prompt (reusing prefix-shared pages), decode grows one page
at a time, and when the pool runs dry the most recently admitted request
is preempted (pages freed, request requeued for recompute).  Sampling is
greedy: ``np.argmax`` of the logits, which takes the first index among
ties.  Every step runs under ``torch.inference_mode()`` and emits a
:class:`StepTelemetry` record.

On the card the continuous engine captures each step in a CUDA graph, the
counterpart of the reference's ``jax.jit(model.paged_step)``: the first
step of each chunk width runs eagerly (it loads the kernels, encodes their
TMA maps and sizes their split workspaces) and is then captured
(:class:`StepGraph`); later steps of that width copy their inputs into the
graph's static buffers and replay it.  ``cuda_graphs=False`` keeps the
eager step; a CPU model always runs it.

``ServeEngine(batch_size=)`` selects the wave engine instead (deprecated,
as in the reference, but the only serving path of the block kinds without
a paged step: whisper's enc-dec, a VLM's cross blocks, the recurrent
kinds): requests run in static waves of ``batch_size`` left-padded
prompts, one ``LM.prefill`` each, then ``LM.decode_step`` against
per-layer caches until every row of the wave is done.  The caches are
allocated once (``LM.init_caches``) and each prefill's are copied into
them, so they keep their addresses.  On the card the decode step is
captured in one CUDA graph per engine (:class:`WaveGraph`, the
counterpart of the reference's ``jax.jit(model.decode_step)``, whose
position is a traced scalar): the engine's first decode step runs eagerly
and is captured, and every later step, in every wave, copies its tokens
and position into the graph's buffers and replays it, on a stream of the
engine's own.  Prefill stays eager, on the caller's stream.  Its
per-phase StepTelemetry records fold into one :class:`WaveTelemetry` per
wave.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cuda_graphs import CapturedStep, pool_bytes
from repro_torch.models.transformer import PAGED_KINDS
from repro_torch.serve.kv_cache import PagedKVCache, cdiv


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (T,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass(frozen=True)
class StepTelemetry:
    """Observability record for ONE engine step.

    ``kv_bytes`` is the KV footprint actually held (allocated pages x page
    bytes across layers); ``kv_bytes_dense`` is what a per-slot max-length
    allocation would hold for the same batch width.  ``wall_s`` is host
    time around the step, which ends when the logits reach the host.
    """

    step: int                # 0-based step index within this run
    phase: str               # "prefill" | "mixed" | "decode"
    live: int                # occupied slots doing useful work this step
    queue_depth: int         # requests waiting for a slot after this step
    tokens: int              # tokens emitted (sampled) this step
    preemptions: int         # requests preempted (requeued) this step
    pages_in_use: int        # KV pages held after this step
    page_occupancy: float    # pages_in_use / allocatable pages
    kv_bytes: int            # bytes held in KV pages (all layers)
    kv_bytes_dense: int      # bytes a dense max-len batch would hold
    prefix_hit_tokens: int   # cumulative prompt tokens skipped via sharing
    wall_s: float            # step wall time (host clock)
    tokens_per_s: float      # tokens / wall_s


@dataclasses.dataclass(frozen=True)
class WaveTelemetry:
    """Aggregated observability for ONE wave of the wave engine, folded
    from the wave's StepTelemetry records (:meth:`from_steps`).
    ``wall_s`` covers prefill and decode; ``prefill_s`` the prefill."""

    wave: int                # 0-based wave index within this generate() call
    requests: int            # requests admitted into the wave
    tokens: int              # tokens emitted by the wave
    decode_steps: int        # decode iterations the wave ran
    wall_s: float            # wave wall time (prefill + decode)
    prefill_s: float         # prefill wall time
    tokens_per_s: float      # tokens / wall_s
    slot_occupancy: float    # mean live-slot fraction over decode steps
    queue_depth: int         # requests still queued when the wave finished

    @classmethod
    def from_steps(cls, wave: int, requests: int, queue_depth: int,
                   steps: List[StepTelemetry], wall_s: float,
                   batch: int) -> "WaveTelemetry":
        """Fold one wave's StepTelemetry stream into its record."""
        emits = [s for s in steps if s.phase != "prefill"]
        n_tok = sum(s.tokens for s in steps)
        prefill_s = sum(s.wall_s for s in steps if s.phase == "prefill")
        occ = (sum(s.live / batch for s in emits) / len(emits)
               if emits else 0.0)
        return cls(
            wave=wave, requests=requests, tokens=n_tok,
            decode_steps=sum(1 for s in emits if s.phase == "decode"),
            wall_s=wall_s, prefill_s=prefill_s,
            tokens_per_s=n_tok / wall_s if wall_s > 0 else 0.0,
            slot_occupancy=occ, queue_depth=queue_depth,
        )


@dataclasses.dataclass
class _Slot:
    req: Request
    length: int                  # tokens written into the KV pages
    pending: np.ndarray          # prompt tokens not yet prefilled
    next_token: Optional[int]    # sampled, not yet written (decode input)
    out: List[int]
    admitted: int                # admission order (preemption picks max)


def _kv_token_bytes(model) -> int:
    """Modeled KV bytes ONE token holds across the paged-kind layers (at
    least one), as the reference models them."""
    cfg = model.cfg
    layers = sum(1 for k in cfg.pattern if k in PAGED_KINDS)
    itemsize = torch.empty((), dtype=model.act_dtype).element_size()
    return 2 * cfg.n_kv_heads * cfg.head_dim * itemsize * max(layers, 1)


def _cache_tensors(caches) -> List[torch.Tensor]:
    """Every tensor of per-layer caches, nested dicts (whisper's wave
    cache ``{"self", "cross"}``) walked in order."""
    out: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, torch.Tensor):
            out.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            for v in node:
                walk(v)

    walk(caches)
    return out


def _copy_caches(dst, src) -> None:
    """Copy a prefill's caches ``src`` into the engine's ``dst`` in place:
    the same structure and, tensor by tensor, the same shape and dtype."""
    dst_t, src_t = _cache_tensors(dst), _cache_tensors(src)
    if len(dst_t) != len(src_t) or any(
            d.shape != t.shape or d.dtype != t.dtype
            for d, t in zip(dst_t, src_t)):
        raise ValueError("the prefill's caches do not match the engine's")
    for d, t in zip(dst_t, src_t):
        d.copy_(t)


class _ModelStepGraph(CapturedStep):
    """A model step ``step() -> (logits, caches)`` captured in one CUDA
    graph (:class:`~repro_torch.core.cuda_graphs.CapturedStep`): the graph
    reads its inputs, the params and ``caches`` at their captured
    addresses and writes the caches in place, so the caller fills the
    inputs in place before each :meth:`replay`, which returns the graph's
    static logits (read them before another replay).  The caller has run
    one eager step of the same shapes on ``stream`` first.  A step that
    rebinds a cache tensor raises ``RuntimeError(rebound)``."""

    def __init__(self, step, caches, held, *, stream, pool, rebound):
        ptrs = [t.data_ptr() for t in _cache_tensors(caches)]

        def fn():
            with torch.inference_mode():
                return step()

        super().__init__(fn, stream=stream, pool=pool, held=held)
        self.logits, out = self.out
        self.out = self.logits
        if out is not caches or ptrs != [t.data_ptr()
                                         for t in _cache_tensors(caches)]:
            raise RuntimeError(rebound)


class StepGraph(_ModelStepGraph):
    """``model.paged_step`` captured in one CUDA graph: ``inputs`` are the
    step's device inputs (tokens (B, c), block tables, q_start, n_valid),
    ``caches`` the KV pools."""

    def __init__(self, model, params, caches, inputs, *, stream, pool):
        super().__init__(
            lambda: model.paged_step(params, inputs[0], caches, *inputs[1:]),
            caches, (inputs, params, caches), stream=stream, pool=pool,
            rebound="paged_step rebound a KV pool during the capture; a "
                    "graph writes the pools in place")


class WaveGraph(_ModelStepGraph):
    """The wave engine's ``model.decode_step`` captured in one CUDA graph:
    ``token`` (B, 1) and ``pos`` (0-d) are the step's device inputs,
    ``caches`` the per-layer caches (nested dicts)."""

    def __init__(self, model, params, caches, token, pos, *, stream, pool):
        super().__init__(
            lambda: model.decode_step(params, token, caches, pos),
            caches, ((token, pos), params, caches), stream=stream,
            pool=pool, rebound="decode_step rebound a cache tensor during "
                               "the capture; a graph writes the caches in "
                               "place")


class ServeEngine:
    """Continuous-batching engine over paged KV, on the model's device.  The
    deprecated ``batch_size=`` keyword selects the wave engine (static
    batch, per-layer caches allocated once: ``caches``).

    ``cuda_graphs``: capture the step in CUDA graphs (``graphs``, by
    chunk width: one a width on the continuous engine, the decode step's
    width 1 on the wave engine); ``None`` means on for a CUDA model and off
    for a CPU one, ``True`` on a CPU model raises.
    """

    def __init__(self, model, params, *, max_len: int,
                 max_batch: Optional[int] = None, page_size: int = 16,
                 max_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 eos_id: int = 1, batch_size: Optional[int] = None,
                 cuda_graphs: Optional[bool] = None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.telemetry: List[WaveTelemetry] = []
        self.step_telemetry: List[StepTelemetry] = []
        self._token_bytes = _kv_token_bytes(model)
        self._wave_mode = batch_size is not None
        on_card = torch.device(model.device).type == "cuda"
        if cuda_graphs and not on_card:
            raise ValueError(f"cuda_graphs=True needs a CUDA model, this one "
                             f"is on {model.device}")
        # Captured steps by chunk width; None runs every step eagerly.
        self.graphs: Optional[Dict[int, CapturedStep]] = (
            {} if on_card and cuda_graphs is not False else None)
        if self._wave_mode:
            warnings.warn(
                "ServeEngine(batch_size=) selects the deprecated wave "
                "engine; use max_batch= for continuous batching",
                DeprecationWarning, stacklevel=2)
            self.batch_size = batch_size
            self.caches = model.init_caches(batch_size, max_len)
            if self.graphs is not None:
                self._init_graph_inputs(
                    dict(tokens=batch_size, pos=1), torch.int64)
            return
        reason = model.paged_unsupported_reason()
        if reason:
            raise ValueError(
                f"continuous batching unavailable: {reason} (construct "
                f"with batch_size= for the wave engine)")
        self.max_batch = max_batch if max_batch is not None else 8
        self.page_size = page_size
        self.bt_width = cdiv(max_len, page_size)
        # Default pool: dense-equivalent capacity (+ the scratch page), so
        # preemption only kicks in when the caller shrinks max_pages.
        self.max_pages = (max_pages if max_pages is not None
                          else self.max_batch * self.bt_width + 1)
        self.kv = PagedKVCache(self.max_pages, page_size)
        self.prefill_chunk = (prefill_chunk if prefill_chunk is not None
                              else max(page_size, 8))
        self.caches = model.init_paged_caches(self.max_pages, page_size)
        self._slots: List[Optional[_Slot]] = [None] * self.max_batch
        self._queue: deque = deque()
        self._admit_counter = 0
        self._step_counter = 0
        self._uid_counter = 0
        self._preempted_now = 0
        if self.graphs is not None:
            b = self.max_batch
            self._init_graph_inputs(
                dict(tokens=b * self.prefill_chunk,
                     block_tables=b * self.bt_width, q_start=b, n_valid=b),
                torch.int32)

    def _init_graph_inputs(self, sizes: Dict[str, int], dtype) -> None:
        """The captured steps' stream, memory pool and static inputs: one
        ``dtype`` device buffer of ``sizes[name]`` values each (continuous:
        tokens, a (B, c) view of it a width, block tables, q_start and
        n_valid; wave: tokens and the position), filled from pinned host
        twins."""
        dev = torch.device(self.model.device)
        self._stream = torch.cuda.Stream(dev)
        # The params and the caches were made on the current stream.
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        self._pool = torch.cuda.graph_pool_handle()
        self._host = {k: torch.zeros(n, dtype=dtype, pin_memory=True)
                      for k, n in sizes.items()}
        self._static = {k: torch.zeros(n, dtype=dtype, device=dev)
                        for k, n in sizes.items()}

    def graph_pool_bytes(self) -> int:
        """Bytes of the card's memory the captured steps' pool holds."""
        return pool_bytes(self._pool)

    def _stage(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` into the static input ``name`` by its pinned host twin
        and a non-blocking copy -> the device buffer's view of its
        shape."""
        host = self._host[name][:arr.size].view(arr.shape)
        host.numpy()[...] = arr
        dev = self._static[name][:arr.size].view(arr.shape)
        dev.copy_(host, non_blocking=True)
        return dev

    def _sample(self, logits) -> np.ndarray:
        """Greedy tokens of (B, Vp) logits on the host (the copy waits for
        the device)."""
        return np.argmax(logits.float().cpu().numpy(), axis=-1)

    def _graph_step(self, tokens, bt, q_start, n_valid) -> np.ndarray:
        """One step through the captured graph of its chunk width: the
        inputs go to the static buffers by pinned non-blocking copies, then
        the graph replays; a width's first step runs eagerly and is then
        captured.  -> the greedy tokens."""
        ins = [self._stage(name, arr) for name, arr in (
            ("tokens", tokens), ("block_tables", bt), ("q_start", q_start),
            ("n_valid", n_valid))]
        c = tokens.shape[1]
        graph = self.graphs.get(c)
        if graph is not None:
            return self._sample(graph.replay())
        logits, self.caches = self.model.paged_step(
            self.params, ins[0], self.caches, *ins[1:])
        sampled = self._sample(logits)
        self.graphs[c] = StepGraph(self.model, self.params, self.caches,
                                   ins, stream=self._stream, pool=self._pool)
        return sampled

    def _require_continuous(self, what: str):
        if self._wave_mode:
            raise RuntimeError(
                f"{what} requires the continuous engine; this instance was "
                f"built with the deprecated batch_size= (wave) engine")

    def add_request(self, prompt, max_new_tokens: int = 16,
                    uid: Optional[int] = None) -> int:
        """Queue a request; returns its uid.  Also accepts a Request."""
        self._require_continuous("add_request()")
        if isinstance(prompt, Request):
            req = prompt
        else:
            if uid is None:
                uid = self._uid_counter
                self._uid_counter += 1
            req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                          max_new_tokens=max_new_tokens)
        self._uid_counter = max(self._uid_counter, req.uid + 1)
        if len(req.prompt) >= self.max_len:
            raise ValueError(f"prompt length {len(req.prompt)} >= max_len "
                             f"{self.max_len}")
        worst = cdiv(min(len(req.prompt) + req.max_new_tokens, self.max_len),
                     self.page_size)
        if worst > self.max_pages - 1:
            raise ValueError(
                f"request {req.uid} needs up to {worst} pages, pool has "
                f"{self.max_pages - 1} allocatable — raise max_pages")
        self._queue.append(req)
        return req.uid

    def _admit(self) -> None:
        """FIFO admission into free slots while prompt pages fit."""
        for i in range(self.max_batch):
            if not self._queue or self._slots[i] is not None:
                continue
            req = self._queue[0]
            shared_pages, shared_tokens = self.kv.match_prefix(req.prompt)
            self.kv.allocate(req.uid, shared_pages, shared_tokens)
            if not self.kv.ensure(req.uid, len(req.prompt)):
                self.kv.free_seq(req.uid)     # head doesn't fit; wait
                self.kv.rollback_prefix_hits(len(shared_pages), shared_tokens)
                break
            self._queue.popleft()
            self._slots[i] = _Slot(
                req=req, length=shared_tokens,
                pending=np.asarray(req.prompt[shared_tokens:], np.int32),
                next_token=None, out=[], admitted=self._admit_counter)
            self._admit_counter += 1

    def _evict_slot(self, i: int) -> None:
        """Preempt slot i: free its pages, requeue its request at the head
        (recompute semantics — generated tokens are discarded)."""
        s = self._slots[i]
        self.kv.free_seq(s.req.uid)
        self._queue.appendleft(s.req)
        self._slots[i] = None
        self._preempted_now += 1

    def _reserve(self, slot: _Slot, n_new: int) -> bool:
        """Grow slot's table for n_new tokens, preempting newer requests
        under page pressure.  False if the slot itself got preempted (or
        already was, by an earlier _reserve() this step)."""
        if not any(s is slot for s in self._slots):
            return False
        while not self.kv.ensure(slot.req.uid, slot.length + n_new):
            others = [i for i, s in enumerate(self._slots)
                      if s is not None and s is not slot]
            if others:
                j = max(others, key=lambda i: self._slots[i].admitted)
                if self._slots[j].admitted > slot.admitted:
                    self._evict_slot(j)
                    continue
            # slot is itself the newest — preempt it instead
            self._evict_slot(
                next(i for i, s in enumerate(self._slots) if s is slot))
            return False
        return True

    def step(self) -> List[Request]:
        """Run one engine step; returns the requests that finished."""
        self._require_continuous("step()")
        t0 = time.perf_counter()
        self._preempted_now = 0
        self._admit()
        live = [s for s in self._slots if s is not None]
        if not live:
            if self._queue:
                raise RuntimeError(
                    "queued requests but nothing admitted — pool cannot "
                    "hold any queued prompt")
            return []
        # Chunk width: mixed prefill step if any prompt is still pending.
        chunk = max((min(self.prefill_chunk, len(s.pending))
                     for s in live if len(s.pending)), default=0)
        c = max(chunk, 1)
        phase = ("prefill" if chunk and all(s.next_token is None
                                            for s in live)
                 else "mixed" if chunk else "decode")
        # Reserve pages for this step's writes (may preempt).  _reserve()
        # can evict any NEWER slot, so re-read liveness from self._slots.
        for i in range(self.max_batch):
            s = self._slots[i]
            if s is None:
                continue
            n_new = min(c, len(s.pending)) if len(s.pending) else 1
            self._reserve(s, n_new)
        live = [s for s in self._slots if s is not None]
        if not live:
            raise RuntimeError("every live request was preempted — pool "
                               "cannot make progress")
        b = self.max_batch
        tokens = np.zeros((b, c), np.int32)
        q_start = np.zeros((b,), np.int32)
        n_valid = np.zeros((b,), np.int32)
        bt = np.zeros((b, self.bt_width), np.int32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            if len(s.pending):
                n = min(c, len(s.pending))
                tokens[i, :n] = s.pending[:n]
            else:
                n = 1
                tokens[i, 0] = s.next_token
            q_start[i] = s.length
            n_valid[i] = n
            bt[i] = self.kv.block_table_row(s.req.uid, self.bt_width)
        if self.graphs is not None:
            with torch.inference_mode(), torch.cuda.stream(self._stream):
                sampled = self._graph_step(tokens, bt, q_start, n_valid)
        else:
            dev = self.model.device
            with torch.inference_mode():
                logits, self.caches = self.model.paged_step(
                    self.params, torch.from_numpy(tokens).to(dev),
                    self.caches, torch.from_numpy(bt).to(dev),
                    torch.from_numpy(q_start).to(dev),
                    torch.from_numpy(n_valid).to(dev))
                sampled = self._sample(logits)
        finished: List[Request] = []
        emitted = 0
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            n = int(n_valid[i])
            s.length += n
            if len(s.pending):
                s.pending = s.pending[n:]
                if len(s.pending):
                    continue              # mid-prefill: logits unused
                self.kv.register_prefix(s.req.uid, s.req.prompt)
            tok = int(sampled[i])
            s.out.append(tok)
            emitted += 1
            done = (tok == self.eos_id
                    or len(s.out) >= s.req.max_new_tokens
                    or s.length >= self.max_len - 1)
            if done:
                s.req.out_tokens = list(s.out)
                finished.append(s.req)
                self.kv.free_seq(s.req.uid)
                self._slots[i] = None
            else:
                s.next_token = tok
        wall = time.perf_counter() - t0
        pages = self.kv.pages_in_use
        rec = StepTelemetry(
            step=self._step_counter, phase=phase, live=len(live),
            queue_depth=len(self._queue), tokens=emitted,
            preemptions=self._preempted_now, pages_in_use=pages,
            page_occupancy=self.kv.occupancy,
            kv_bytes=pages * self.page_size * self._token_bytes,
            kv_bytes_dense=self.max_batch * self.max_len * self._token_bytes,
            prefix_hit_tokens=self.kv.stats.prefix_hit_tokens,
            wall_s=wall, tokens_per_s=emitted / wall if wall > 0 else 0.0)
        self.step_telemetry.append(rec)
        self._step_counter += 1
        return finished

    @property
    def pending(self) -> int:
        """Requests not yet finished (queued + occupying a slot)."""
        self._require_continuous("pending")
        return len(self._queue) + sum(s is not None for s in self._slots)

    def warm_prefixes(self, prompts,
                      *, max_tokens_each: Optional[int] = None) -> int:
        """Pre-populate the prefix-sharing index with system prompts.

        Runs each prompt through a throwaway 1-token request so its full
        prompt pages land in the refcounted prefix index before real
        traffic arrives.  Prompts shorter than one page are skipped; longer
        ones are truncated to ``max_tokens_each`` and to what ``max_len``
        admits.  Resets the telemetry stream afterwards.  Returns the
        number of newly indexed prefix pages.
        """
        self._require_continuous("warm_prefixes()")
        before = self.kv.prefix_entries
        budget = 0
        for prompt in prompts:
            toks = np.asarray(prompt, np.int32).reshape(-1)
            if max_tokens_each is not None:
                toks = toks[:max_tokens_each]
            toks = toks[: self.max_len - 2]
            if len(toks) < self.page_size:
                continue              # sharing covers full pages only
            self.add_request(toks, max_new_tokens=1)
            budget += 4 * (len(toks) + 1) + 64
        for _ in range(budget):
            if not self.pending:
                break
            self.step()
        if self.pending:
            raise RuntimeError(
                f"prefix warm-up failed to drain: {self.pending} warm "
                f"requests unfinished")
        self.step_telemetry = []
        self._step_counter = 0
        return self.kv.prefix_entries - before

    def generate(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Run every request to completion; resets the telemetry streams.
        The wave engine runs its waves (:meth:`_generate_waves`)."""
        if self._wave_mode:
            return self._generate_waves(requests)
        self.step_telemetry = []
        self._step_counter = 0
        for r in requests:
            self.add_request(r)
        results: Dict[int, List[int]] = {}
        budget = sum(len(r.prompt) + r.max_new_tokens for r in requests)
        budget = 4 * budget + 64          # preemption/chunking slack
        for _ in range(budget):
            for req in self.step():
                results[req.uid] = list(req.out_tokens)
            if not self.pending:
                return results
        raise RuntimeError(f"generate() exceeded its step budget with "
                           f"{self.pending} requests unfinished")

    # ----------------- deprecated wave engine (batch_size=) --------------

    def _generate_waves(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Static-batch generation, ``batch_size`` requests per wave in
        arrival order."""
        results: Dict[int, List[int]] = {}
        queue = list(requests)
        self.telemetry = []
        self.step_telemetry = []
        self._wave_step = 0
        wave_idx = 0
        while queue:
            wave = queue[: self.batch_size]
            queue = queue[self.batch_size:]
            t0 = time.perf_counter()
            n_steps0 = len(self.step_telemetry)
            with torch.inference_mode():
                out = self._run_wave(wave, len(queue))
            wall = time.perf_counter() - t0
            self.telemetry.append(WaveTelemetry.from_steps(
                wave_idx, len(wave), len(queue),
                self.step_telemetry[n_steps0:], wall, self.batch_size))
            results.update(out)
            wave_idx += 1
        return results

    def _wave_record(self, phase: str, live: int, queue_depth: int,
                     tokens: int, wall: float) -> None:
        dense = self.batch_size * self.max_len * self._token_bytes
        self.step_telemetry.append(StepTelemetry(
            step=self._wave_step, phase=phase, live=live,
            queue_depth=queue_depth, tokens=tokens, preemptions=0,
            pages_in_use=0, page_occupancy=0.0,
            kv_bytes=dense, kv_bytes_dense=dense, prefix_hit_tokens=0,
            wall_s=wall, tokens_per_s=tokens / wall if wall > 0 else 0.0))
        self._wave_step += 1

    def _run_wave(self, wave: List[Request], queue_depth: int):
        """One wave: left-padded prefill, then decode steps at the wave's
        shared position until every row has its tokens (or eos), or the
        position reaches ``max_len - 1``."""
        b = self.batch_size
        model, dev = self.model, self.model.device
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt       # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        cfg = model.cfg
        # The stubbed modality frontends: zero frame or patch embeddings.
        if cfg.family == "audio":
            batch["audio_embeds"] = torch.zeros(
                (b, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        if cfg.family == "vlm":
            batch["image_embeds"] = torch.zeros(
                (b, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=dev)
        t_pf = time.perf_counter()
        logits, caches = model.prefill(self.params, batch,
                                       max_len=self.max_len)
        _copy_caches(self.caches, caches)
        del caches
        tok = self._sample(logits)
        self._wave_record("prefill", len(wave), queue_depth, 0,
                          time.perf_counter() - t_pf)
        out = {r.uid: [] for r in wave}
        live = np.array([True] * len(wave) + [False] * (b - len(wave)))
        max_new = max(r.max_new_tokens for r in wave)
        pos = plen
        for _ in range(max_new):
            # Emission: live slots doing useful work this step over the
            # static batch width (the occupancy sample).
            t_it = time.perf_counter()
            n_live = int(live.sum())
            emitted = 0
            for i, r in enumerate(wave):
                if live[i]:
                    out[r.uid].append(int(tok[i]))
                    emitted += 1
                    if (int(tok[i]) == self.eos_id
                            or len(out[r.uid]) >= r.max_new_tokens):
                        live[i] = False
            if not live.any() or pos >= self.max_len - 1:
                # Final flush: tokens emitted, no decode ran.
                self._wave_record("emit", n_live, queue_depth, emitted,
                                  time.perf_counter() - t_it)
                break
            tok = self._wave_decode(tok, pos)
            pos += 1
            self._wave_record("decode", n_live, queue_depth, emitted,
                              time.perf_counter() - t_it)
        return out

    def _wave_decode(self, tok: np.ndarray, pos: int) -> np.ndarray:
        """One decode step of the wave at position ``pos`` on the greedy
        tokens ``tok`` (B,) -> the next greedy tokens.  With graphs, the
        step runs on the graphs' stream, ordered after the current
        stream's work (the prefill that filled the caches) and before its
        next: the inputs go to the static buffers by pinned non-blocking
        copies and the graph replays; the engine's first step runs eagerly
        and is then captured.  The prefill stays on the current stream,
        whose cached memory it reuses."""
        model = self.model
        if self.graphs is None:
            token = torch.from_numpy(tok.astype(np.int64))[:, None].to(
                model.device)
            logits, _ = model.decode_step(self.params, token, self.caches,
                                          pos)
            return self._sample(logits)
        current = torch.cuda.current_stream(model.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            sampled = self._graph_decode(tok, pos)
        current.wait_stream(self._stream)
        return sampled

    def _graph_decode(self, tok: np.ndarray, pos: int) -> np.ndarray:
        token = self._stage("tokens", tok.reshape(self.batch_size, 1))
        pos_t = self._stage("pos", np.asarray(pos))
        graph = self.graphs.get(1)
        if graph is not None:
            return self._sample(graph.replay())
        logits, _ = self.model.decode_step(self.params, token, self.caches,
                                           pos_t)
        sampled = self._sample(logits)
        self.graphs[1] = WaveGraph(self.model, self.params, self.caches,
                                   token, pos_t, stream=self._stream,
                                   pool=self._pool)
        return sampled
