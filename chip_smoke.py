#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit; build every kernel from ``csrc/`` with
   nvcc (one process per source, in parallel) and print the build seconds;
2. K1 against its plain version at the full-width phi3-mini and
   granite-moe-1b-a400m 2-D GEMM shapes (decode M = 2 and chunked prefill
   M = 32; granite's attention projections, its f32 router and its tied
   head read as B^T), a ragged edge case and an f32 case, each row naming
   the design that ran it (``kernels/mpgemm.py::k1_design``: bf16 or int8
   with 16-byte rows on the wgmma design, TMA and wgmma --
   ``kernels/csrc/mpgemm_wgmma.cu`` for bf16, ``mpgemm_wgmma_int8.cu``
   for int8, whose MN-major operands are transposed in shared memory; f32
   operands on tf32x3, ``mpgemm_wgmma_f32.cu``, but those of the fp32
   policy -- granite's router -- which keep f32 FMA arithmetic on the fma
   design, ``mpgemm_fma.cu``, held bit for bit to the scalar loop and
   timed beside it; the rest on ``kernels/csrc/mpgemm.cu``'s scalar
   loops); then K1's int8
   variant (int8 operands, exact int32 sum, device scale) at the same
   shapes but the router, every launch on the wgmma design;
3. K5 against its plain version at phi3-mini's, granite's,
   starcoder2-3b's (GQA 12:1), phi3-medium-14b's (4:1) and mixtral-8x22b's
   (6:1, window 4096; also past the window, 4600 keys) attention shapes
   (decode and 16-token chunked prefill) and at a GQA +
   sliding-window shape, with ragged lengths, dead block-table slots over
   a NaN-filled scratch page and one idle row, each case on the design
   ``kernels/flash_attention.py::k5_design`` names (bf16: the split or
   wgmma body of ``kernels/csrc/flash_attention_wgmma.cu`` over the block
   table; f32: ``kernels/csrc/paged_flash.cu``), the same bits from two
   launches, beside SDPA over K/V gathered beforehand; then
   K4 at whisper-medium's shapes (the encoder's 1500 x 1500 non-causal
   self-attention, the decoder's causal prefill, cross-attention at
   prefill and at decode), phi3-mini's causal prefill, a GQA 32:8 head of
   120 with a window and tq < tk, llama-3.2-vision-11b's (GQA 4:1, D 128:
   causal prefill, cross-attention over 1600 image keys at prefill and at
   decode), recurrentgemma-2b's local attention (MQA 10:1, D 256 -- above
   K4_MAX_D, so the first scalar kernel by the rule -- at a 32-token
   prefill, a 2560-token one its window of 2048 cuts, and one query row
   over a full 2048-slot ring), and three f32 cases (one granite's
   fp32 training attention), each on the design
   ``kernels/flash_attention.py::k4_design`` names (bf16: the wgmma or
   the split design of ``kernels/csrc/flash_attention_wgmma.cu``; f32:
   the tf32x3 design of ``kernels/csrc/flash_attention_tf32x3.cu``, or
   at 16 folded rows the first scalar kernel
   ``kernels/csrc/flash_attention.cu``, which every f32 case also holds
   against the plain version),
   the same bits from two launches, beside SDPA (no mask where every key
   is seen, ``is_causal`` for a causal square, else the mask);
4. K6 (``kernels/csrc/pack.cu``) packing every full-width phi3-mini weight
   shape and a ragged ``trans_w`` one into bf16, int8, int4 and fp8
   payloads on its stream design (``packing/pack.py::k6_design``) and on
   its first scalar kernel (timed beside it), and a case whose rows the
   stream design does not take through the wrapper on the scalar one:
   payload and scales byte-equal to its plain version;
5. K2 at phi3-mini's shapes, M = 2 and 32, for every payload under the
   bf16 policy (bf16 A) and the int8 and int4 payloads under the int8
   policy (int8 A and its scale), and at granite's attention projections
   for the two served payloads (int4 under bf16, int8 under int8),
   against its plain version, each case on the wgmma design
   ``kernels/mpgemm.py::k2_design`` names (``kernels/csrc/
   mpgemm_packed_wgmma.cu`` for bf16 A, ``mpgemm_packed_wgmma_int8.cu``
   for int8 A; the scalar ``mpgemm_packed.cu`` keeps f32 A, int8 A x fp8
   and other tiles) and the same bits from two launches;
6. the grouped variants at granite-moe-1b-a400m's expert shapes (32
   experts, K/N 1024 <-> 512, M = 2 and 32 rows per expert): grouped K1
   with bf16 A and with int8 A (f32 outputs, the SwiGLU gate fused into
   the gate GEMM), grouped K2 with int4 and bf16 payloads under bf16 A and
   int8 payloads under int8 A (the wgmma design, the same bits from two
   launches), each against its plain version; grouped K6
   packing every weight shape of the model (byte-equal, the stream design
   and the scalar kernel, both timed), then all 72
   expert stacks of a full-width model into int4, byte-equal; then K3 on
   tile-sparse weights built on the card: phi3-mini's GEMMs at 50 %
   magnitude, bf16 A x bf16 tiles and int8 A x int8 tiles with the
   activation scale, granite's attention projections and (grouped) expert
   stacks under int8 N:M 2:4, and an edge case with an empty column and a
   K tail, at M = 2 and 32, each case on the design
   ``kernels/mpgemm.py::k3_design`` names (the wgmma design,
   ``kernels/csrc/mpgemm_sparse_wgmma.cu`` / ``_int8.cu``, walking each
   column's stored tiles; the int8 edge case's rows of 3000 bytes on
   ``mpgemm_sparse.cu``), the same bits from two launches, each weight's
   largest and mean stored tiles a column printed;
   after them (in the run's order) K1 ``trans_a``, K1's fma design
   (``phase_k1_fma``: every product of a granite fp32 training step --
   forward, dX, dW, 2-D and grouped, the tied head -- the router at M =
   1, 2, 16, 17, 32 and 512, ragged M, N and K of every transpose pair
   and each epilogue kind, each case bit-equal to the scalar loop, the
   same bits twice, within 1e-4 of the plain version, timed beside the
   scalar loop, the plain version and ``torch.matmul``), K1 at every GEMM
   shape of one decode step of the six architectures phase 7 adds
   (``phase_k1_archs``, from each config's block kinds: bf16 on the wgmma
   design -- among them mixtral's 8 grouped experts, d 6144 -> 16384 --
   and the fp32 policy's products on the fma design, bit-equal to the
   scalar loop: mixtral's routers, the RWKV LoRA as 5 groups of K 32, the
   RG-LRU gates at 2560 x 2560), K7 and the packed backward of phase 8;
7a. the op-level API (``phase_ops``) and the kernel variants only it
   reaches, each row driven once with every launch count at 0 and each
   case held against its plain version: the paper's 24 Table III GEMMs
   (``TABLE_III``, a copy of ``benchmarks/common.py``'s) through
   ``kernels.ops.mpgemm`` in f32 -> f32 (tf32x3, held to the tf32 peak;
   ``bound_f32_fma_ms`` and ``bound_3xtf32_ms`` beside it; and again on
   the fma design, ``mpgemm(..., f32_fma=True)``, each shape first held
   bit for bit to the scalar loop), bf16 -> bf16 and
   int8 -> int32 (equal to the plain version; ``torch.matmul`` and
   ``torch._int_mm`` as yardsticks), K1's beta·C and integer epilogues at
   W1, W13 and W19, int8 ``trans_a`` and ``trans_a`` + ``trans_b`` at W13
   and W19, a row per precision (each case naming its design); K2 and K3
   ``trans_a`` (A read (K,
   M) at phi3-mini's ``w_up``, M = 2 and 32; the wrapper's copy of Aᵀ
   timed alone);
   ``mp_dot(..., quant_in=True)`` (silu, and a residual) at phi3-mini's
   full-width projections, M = 2 and 32, over a dense bf16 weight (K1),
   packed int8, int4 and fp8 payloads (K2; fp8 is K2's int8 x fp8 loop), a
   packed bf16 payload and an int8 tile-sparse one (K3), and one
   straight-through backward; K3 with bf16 A against int8 tiles; K2 and K3
   beta·C; at granite's expert shapes grouped K1 beta·C, ``quant_in`` over
   grouped K1, K2 (int8) and K3 (int8 N:M 2:4), and one
   ``mp_einsum("gmk,gkn->gmn")``; then ``--no-fuse`` serving (the unfused
   MLPs) of full-width phi3-mini at 8 layers and granite-moe-1b-a400m at 6
   (the same traffic as below; the same launch counts as fused; one mixed
   step's logits against the fused model's within 2 % of the largest
   |logit|);
7. serving 4 requests through ``repro_torch.serve.engine.ServeEngine``:
   full-width phi3-mini-3.8b (random weights from a seed), dense bf16 (225
   K1 and 32 K5 launches per ``paged_step``), packed from the f32 draw by
   K6 with int4 payloads under bf16 and with int8 payloads under the int8
   policy, at 16 of its 32 layers (113 K2, 16 K5 and 0 K1 launches per
   step), and dense under the int8 policy at 4 layers (29 int8 K1
   launches per step); then full-width granite-moe-1b-a400m over the same
   traffic, dense bf16 (121 K1, 72 grouped K1, 24 K5 per step), packed
   int4 under bf16 and packed int8 under int8 at 12 of its 24 layers (48
   K2, 36 grouped K2, 13 K1 -- routers and the tied head -- and 12 K5 per
   step; 84 K6 launches at load), and dense int8 at 4 layers (21 K1 and
   12 grouped K1 per step); and the two tile-sparse paths at full width
   and half depth: phi3-mini under bf16 at sparsity 0.5 by magnitude (113
   K3, 16 K5 and 0 K1 per step) and granite under int8 with N:M 2:4 (48
   K3, 36 grouped K3, 13 K1, 12 K5 per step), each sparsified from the
   f32 draw through K6 (113 and 84 launches at load; every K6 launch of
   a load on the stream design); then dense bf16 at full width
   starcoder2-3b (30 layers: 6 K1 a layer, GELU MLP with biases),
   phi3-medium-14b (40 layers) and mixtral-8x22b at 8 of its 56 layers
   (all 56 hold ~280 GB of bf16 weights; 5 K1, 3 grouped K1 a layer).
   Each path serves
   through the engine's CUDA graphs (one a chunk width, the decode graph
   replayed; the graphs, replays, capture seconds and pool MB printed),
   then the same requests on the eager step (``cuda_graphs=False``),
   which must give the same tokens.  Every launch count of each run is
   asserted (a replay counts its graph's launches), every bf16 and int8
   K1 launch must have run the wgmma design and none tf32x3 (the MoE
   routers keep the fp32 policy's f32 FMA: every router launch on the fma
   design), every K2, grouped K2, K3 and
   grouped K3 launch its wgmma design and every K5 launch K5's split or
   wgmma design, every step's logits are finite, and for each path one
   full-width mixed step through the kernels agrees with the same step
   through the plain versions; one replayed two-row decode step's logits
   equal the eager step's bit for bit, and both are timed on the host
   clock and traced with ``torch.profiler`` (the device's busy time and
   idle share, its ops by kind); then the wave
   engine (``ServeEngine(batch_size=2)``) over the same traffic, dense
   bf16: full-width whisper-medium (24 encoder and 24 decoder layers, 385
   K1 and 72 K4 per prefill, 193 K1 and 24 K4 per decode step) and
   full-width phi3-mini (225 K1 and 32 K4 per prefill, 225 K1 per decode
   step), full-width llama-3.2-vision-11b (40 layers, 8 of them gated
   cross-attention over 1600 zero image embeddings, as the engine stubs
   them), rwkv6-1.6b (24 layers, its grouped f32 LoRA on the fma design)
   and recurrentgemma-2b (18 RG-LRU layers, their f32 gates on the fma
   design, and 8 local-attention layers of D 256 on K4's first scalar
   kernel), with the same checks (every K4 launch on the wgmma or split
   design but those D 256 ones, each launch count by block kind:
   ``_want_wave_launches``), one prefill and one decode step against the
   plain versions (the VLM's with image embeddings drawn from a seed and
   its cross gates opened to 0.5); each wave path is served through the
   wave engine's CUDA graph (its first decode step eager and captured,
   every later one replayed; the graphs, replays, capture seconds and
   pool MB printed) and again on the eager step (``cuda_graphs=False``),
   both after an untimed eager warm-up:
   the same tokens, exact launch counts in both runs (decode steps are
   the telemetry's: the capture's eager step plus the replays), one
   replayed two-row decode step's logits equal the eager step's bit for
   bit (the caches restored before each), and both steps timed and
   traced;
8. the training path: K1 ``trans_a`` (A read (K, M), the weight
   gradients) at a 512-token training step's dW shapes -- granite's
   attention projections, f32 router, tied embedding (49280 x 1024) and
   (grouped) expert stacks at the training capacity, phi3-mini's
   projections and head -- against its plain version and deterministic;
   K7 (the unpacker, ``kernels/csrc/pack.cu``) bit-equal to its plain
   version on every full-width phi3-mini weight packed bf16, int8, int4
   and fp8 and on granite's expert stacks, on its stream design
   (``k7_design``) and on its scalar kernel, both timed (a bf16 payload
   also beside the one PyTorch copy that computes the same function);
   ``mp_dot`` forward and
   backward on a packed phi3 ``w_up`` (bf16: K2, K7, K1 trans_b and
   trans_a, K6; int4: frozen, dx only) and a bf16 payload's forward under
   int8 (K7, int8 K1), against the plain versions, every K6 and K7 launch
   on the stream design; then
   ``repro_torch.launch.train.main`` (``TRAIN_PATHS``): full-width
   granite-moe-1b-a400m, all 24 layers, bf16, batch 4 x seq 128, remat, 4
   steps with a checkpoint, the same at 12 layers under fp32 (every
   product on K1's fma design, attention on K4's tf32x3 design), and
   phi3-mini at full width cut
   to 4 layers under int8 (the STE), 4 steps -- each with the step
   captured in a CUDA
   graph (the CLI's default: the first step eager, then replays; the
   ``CUDA graphs:`` line) and again on the eager loop
   (``Trainer(cuda_graphs=False)``) from the same seed and batches:
   finite loss and grad norm, exact launch counts a step
   (``_want_train_launches``; the wgmma designs' among them: every bf16
   and int8 K1 launch and every K4 launch under bf16 and int8; the fma
   design every f32 K1 one, the tf32x3 design every f32 K4 one), the
   backward ops that sum rows several tokens share repeating themselves,
   the captured run's losses, grad norms and final parameters, AdamW
   moments and step equal to the eager run's bit for bit (granite's bf16
   run also under deterministic algorithms, once),
   ``--resume`` restoring bit-identical parameters and AdamW state, a
   run resumed after its first step reaching the uninterrupted run's
   state bit for bit, one step's loss and gradients against the plain versions, step
   time, tokens/s, peak memory and the graph pool, and one eager and one
   replayed step traced with ``torch.profiler``;
8b. the block planner (``phase_plans``): every K1, K2 and K3 launch shape
   the phases above ran on a design that takes a plan (all but simt) took
   the analytic plan, which equals the design
   rules (``k1_wgmma_bm``, ``k1_split``, ``k2_split``, ``k3_split``,
   ``k1_fma_tile``); the plan cache's lookup counts and the host
   microseconds a launch spends resolving its plan; then three groups of
   shapes where K1 ran behind the library -- phi3-mini's projections at
   M = 32, granite's training dW (``trans_a``), mixtral's grouped experts
   at decode -- tuned on the card (``tuning.tune_gemm`` /
   ``tune_grouped_gemm``, ``"cuda"`` mode) into a temporary
   ``REPRO_TORCH_PLAN_CACHE`` file: every candidate's time, the winner
   against the analytic plan, the library call and the bound, each tuned
   plan launched through ``mpgemm`` (a ``hit_tuned`` lookup) and held to
   the plain version, and cached plans outside the kernel's limits
   raising at launch;
9. the script's wall time, one JSON line with every ported kernel's
   launches (and, for K2, K3, K5 and the op rows, the launches on each
   design), error and times;
10. the card line, then ``{"ok": true, "device": {...}}`` as the last
    line.

Times come from CUDA events around single launches, each after a 256 MiB
write that evicts the 50 MB L2 (serving reads every weight cold once per
step) and a spin of the card that hides the wrapper's host work
(``Timer``).  A kernel's decode-step time is the sum over one full-width decode
step's launches at M = 2, each timed alone.  ``bound_ms`` is the larger of
bytes / 3.35 TB/s and operations / peak (989 TFLOP/s bf16, 67 TFLOP/s f32,
1979 TOP/s int8), counting each input read once and each output written
once; a launch on K1's f32 design (tf32x3) divides its 2·M·N·K by the
tf32 tensor cores' 495 TFLOP/s, the peak it runs at, and its op row also
carries ``bound_f32_fma_ms`` (the same work over the f32 CUDA cores' 67
TFLOP/s, the scalar design's bound) and ``bound_3xtf32_ms`` (three tf32
products a multiply-add: the design's own work).  ``library_ms`` times one
PyTorch call of the same function as a yardstick; the port never calls it.
"""
import collections
import contextlib
import faulthandler
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
# Dense peaks of an H100 SXM (NVIDIA's data sheet): bf16, tf32 and int8 on
# the tensor cores, f32 FMA on the CUDA cores.
PEAK_OPS = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12,
            "int8": 1979e12}
FLUSH_BYTES = 256 << 20
ITERS = 10

# Tolerances, kernel against plain version on the same card and inputs:
# bf16 outputs may differ by one bf16 rounding (2**-8 relative) because the
# f32 sums run in another order; f32 outputs by f32 summation order only.
# K6 (the packer) has none: its payload and scales must be byte-equal.
TOL = {"bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
       "float32": dict(rtol=1e-4, atol=1e-4)}
# Full-width bf16 logits after 32 layers: each GEMM output and the residual
# stream are rounded to bf16, and a rounding that lands on the other side in
# one layer moves the hidden state of every later one.  A logit's error is
# that hidden-state error times the head, so it scales with the logits'
# range, not with each logit: the bound is 2 % of the largest |logit|, about
# five bf16 ulps (2**-8 relative each) at that magnitude.
# Under the int8 policy every GEMM input is also re-quantized per tensor to
# 255 levels (step amax / 127).  An input that differs by one bf16 rounding
# between the two runs crosses a level boundary with a probability of about
# 127 * 2**-8 * |x| / amax and then moves by a whole step: some nine bf16
# ulps at |x| near the activations' standard deviation (amax is about 4.4
# of them over 10**5 values).  What each layer passes on is that much
# heavier-tailed, so the int8 bound is 5 % of the largest |logit|.
LOGIT_REL_TOL = {"bf16": 2e-2, "int8": 5e-2}


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device milliseconds of single launches, each on a cold L2.

    The card spins for ``SPIN_CYCLES`` after the flush, before the start
    event: the host's work in ``fn`` before its launch (a wrapper's
    checks, some tens of microseconds) then runs while the card is busy,
    and the events time the launch alone.  Without it, a wrapper slower
    than the flush left the card idle inside the timed span, and a
    launch of a few microseconds read up to 50 % high, at random."""

    SPIN_CYCLES = 1_000_000      # about 0.5 ms at an H100's clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, iters=ITERS):
        torch = self.torch
        for _ in range(2):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def _sha1(*arrays):
    """The sha1 of the arrays' bytes, in order: equal digests, equal
    bits."""
    import hashlib
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _peak_of(design, dtype_name):
    """The peak a launch's bound divides by: the tf32 tensor cores' for
    K1's f32 design, which does its 2·M·N·K operations there (as three
    products each, its own cost: ``bound_3xtf32_ms``), else the operands'
    type's."""
    return "tfloat32" if design == "tf32x3" else dtype_name


# phi3-mini's GEMMs: (name, K, N, epilogue kind, activation, launches per
# full-width decode step); 4 * 32 + 3 * 32 + 1 = 225.
MAIN_SHAPES = [
    ("qkvo", 3072, 3072, "linear", None, 4 * 32),
    ("up", 3072, 8192, "linear", None, 32),
    ("gate", 3072, 8192, "gated", "silu", 32),
    ("down", 8192, 3072, "residual", None, 32),
    ("head", 3072, 32128, "linear", None, 1),
]
# granite-moe-1b-a400m's 2-D GEMMs: (name, K, N, dtype, trans_b, launches
# per full-width decode step).  wq/wo are 1024 x 1024 and wk/wv 1024 -> 512
# (8 KV heads of 64); the router runs under the fp32 policy (f32 operands
# and output); the tied head is the (49280, 1024) embedding read as B^T.
# 2 * 24 + 2 * 24 + 24 + 1 = 121 in a dense bf16 step; under the int8
# policy the router stays f32 and the other 97 are int8.
GRANITE_LAYERS = 24
# mixtral-8x22b's served depth: 8 of its 56 layers (phase 7 says why).
MIXTRAL_LAYERS = 8
GRANITE_2D_SHAPES = [
    ("wq/wo", 1024, 1024, "bfloat16", False, 2 * GRANITE_LAYERS),
    ("wk/wv", 1024, 512, "bfloat16", False, 2 * GRANITE_LAYERS),
    ("router", 1024, 32, "float32", False, GRANITE_LAYERS),
    ("head", 1024, 49280, "bfloat16", True, 1),
]


class StepSum:
    """A kernel's times over one full-width decode step: each M = 2 case
    weighted by its launches per step."""

    def __init__(self):
        self.ms = self.plain_ms = self.library_ms = self.bound_ms = 0.0
        self.launches = self.bytes = self.ops = 0
        self.max_abs_err = 0.0
        self.designs = []      # the design of each case, where recorded
        self.scalar_ms = None  # the first scalar kernel's, where timed

    def add(self, per_step, ms, plain_ms, library_ms, bound_ms, n_bytes,
            n_ops, scalar_ms=None):
        self.ms += per_step * ms
        self.plain_ms += per_step * plain_ms
        self.library_ms += per_step * library_ms
        self.bound_ms += per_step * bound_ms
        self.launches += per_step
        self.bytes += per_step * n_bytes
        self.ops += per_step * n_ops
        if scalar_ms is not None:
            self.scalar_ms = (self.scalar_ms or 0.0) + per_step * scalar_ms

    def row(self, peak_dtype):
        _, bound_by = _bound_ms(self.bytes, self.ops, peak_dtype)
        row = dict(ms=self.ms, plain_ms=self.plain_ms,
                   library_ms=self.library_ms, bound_ms=self.bound_ms,
                   bound_by=bound_by, max_abs_err=self.max_abs_err)
        if self.scalar_ms is not None:
            row["scalar_ms"] = self.scalar_ms
        return row


def _check_close(torch, label, got, ref, tol):
    err = (got.float() - ref.float()).abs().max().item()
    if not torch.allclose(got.float(), ref.float(), **tol) or \
            not torch.isfinite(got.float()).all():
        raise AssertionError(
            f"{label}: max |kernel - plain| = {err:.3e} beyond "
            f"rtol={tol['rtol']}, atol={tol['atol']}")
    return err


# ------------------------------------------------------------------ phase 2

def phase_k1(torch, timer):
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for m in (2, 32):
        for name, k, n, kind, act, per_step in MAIN_SHAPES:
            cases.append(dict(name=f"{name}", m=m, k=k, n=n, kind=kind,
                              act=act, dtype=bf16, trans_b=False,
                              bias=False, per_step=per_step, model="phi3"))
        for name, k, n, dt, trans_b, per_step in GRANITE_2D_SHAPES:
            cases.append(dict(name=f"g-{name}", m=m, k=k, n=n, kind="linear",
                              act=None, dtype=getattr(torch, dt),
                              trans_b=trans_b, bias=False, per_step=per_step,
                              model="granite"))
    cases.append(dict(name="edge", m=37, k=129, n=100, kind="linear",
                      act="relu", dtype=bf16, trans_b=True, bias=True,
                      per_step=0, model=None))
    cases.append(dict(name="edge-small", m=5, k=200, n=77, kind="residual",
                      act="gelu", dtype=bf16, trans_b=False, bias=True,
                      per_step=0, model=None))
    cases.append(dict(name="f32", m=32, k=3072, n=3072, kind="gated",
                      act="silu", dtype=f32, trans_b=False, bias=True,
                      per_step=0, model=None))

    # Decode steps (M = 2) by model, and the same launches at M = 32 (a
    # 32-token chunk of prefill); granite's routers alone (the fp32
    # policy's f32 FMA: the fma design, held to the scalar loop bit for
    # bit, whose time is kept beside it).
    steps = {"phi3": StepSum(), "granite": StepSum(),
             "phi3-m32": StepSum(), "granite-m32": StepSum(),
             "granite-router": StepSum(), "granite-router-m32": StepSum()}
    scalar_ms = {"granite-router": 0.0, "granite-router-m32": 0.0}
    has_fma = _rule("k1_fma_tile") is not None
    for c in cases:
        m, k, n, dt = c["m"], c["k"], c["n"], c["dtype"]
        a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        wshape = (n, k) if c["trans_b"] else (k, n)
        w = (torch.randn(*wshape, generator=gen, device="cuda")
             * (2.0 / (k + n)) ** 0.5).to(dt)
        bias = (torch.randn(n, generator=gen, device="cuda")
                if c["bias"] else None)
        extras = ()
        if c["kind"] != "linear":
            extras = (torch.randn(m, n, generator=gen, device="cuda").to(dt),)
        ep = EpilogueSpec(kind=c["kind"], activation=c["act"])
        spec = GemmSpec(trans_b=c["trans_b"])

        def kern():     # granite's router: the fp32 policy's f32 FMA
            return mpgemm(a, w, bias=bias, extras=extras, spec=spec,
                          epilogue=ep, out_dtype=dt,
                          f32_fma=c["model"] == "granite" and dt == f32)

        def plain():
            return mpgemm_plain(a, w, bias=bias, extras=extras,
                                trans_b=c["trans_b"], epilogue=ep,
                                out_dtype=dt)

        def library():
            acc = torch.matmul(a, w.t() if c["trans_b"] else w)
            return apply_epilogue(
                ep, acc.float(),
                bias=None if bias is None else bias.reshape(1, -1),
                extras=extras).to(dt)

        def scalar():
            return _k1_scalar(torch, a, w, trans_b=c["trans_b"], bias=bias,
                              extras=extras, epilogue=ep, out_dtype=dt)

        label = f"K1 {c['name']} m={m} k={k} n={n}"
        (got, design), ref = _k1_design_of(kern), plain()
        router = c["model"] == "granite" and dt == f32
        if router and has_fma and design != "fma":
            raise AssertionError(f"{label}: ran {design}, want fma")
        if design == "fma":
            _check_fma_bits(torch, label, got, kern(), scalar())
        torch.cuda.synchronize()
        tol = TOL[_dtype_name(dt)]
        err = _check_close(torch, label, got, ref, tol)
        for model in ([c["model"], f"{c['model']}-m32"] if c["model"]
                      else steps):
            steps[model].max_abs_err = max(steps[model].max_abs_err, err)
        esz = a.element_size()
        n_bytes = (m * k + k * n + m * n) * esz + m * n * esz * len(extras) \
            + (4 * n if bias is not None else 0)
        n_ops = 2 * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops,
                                    _peak_of(design, _dtype_name(dt)))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        sc_ms = timer(scalar) if router else None
        print(f"[k1] {c['name']:>10} {_dtype_name(dt):>8} {design:>5} "
              f"m={m:<3} k={k:<5} n={n:<6} trans_b={c['trans_b']:d} "
              f"{c['kind']:>8}/{c['act']}: "
              f"err {err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})"
              + ("  bit-equal to the scalar loop, deterministic"
                 if design == "fma" else "")
              + f"  kernel {ms:.4f} ms"
              + (f"  scalar loop {sc_ms:.4f}" if router else "")
              + f"  plain {plain_ms:.4f}  library "
              f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
              f"{n_bytes / ms / 1e6:.1f} GB/s")
        if c["per_step"]:
            key = c["model"] if m == 2 else f"{c['model']}-m32"
            steps[key].add(c["per_step"], ms, plain_ms, lib_ms, bound,
                           n_bytes, n_ops)
            if router:
                key = key.replace("granite", "granite-router")
                steps[key].add(c["per_step"], ms, plain_ms, lib_ms, bound,
                               n_bytes, n_ops)
                steps[key].max_abs_err = max(steps[key].max_abs_err, err)
                scalar_ms[key] += c["per_step"] * sc_ms
    rows = {}
    for model, step in steps.items():
        router = model.startswith("granite-router")
        row = rows[model] = step.row("float32" if router else "bfloat16")
        what = ("M=32 chunk of prefill" if model.endswith("-m32") else
                "decode step (M=2)")
        if router:
            row["scalar_ms"] = scalar_ms[model]
        print(f"[k1] one full-width {model.split('-')[0]} {what}, "
              f"{step.launches} "
              + ("router " if router else "")
              + f"launches: kernel {row['ms']:.3f} ms, "
              + (f"scalar loop {row['scalar_ms']:.3f} ms, " if router
                 else "")
              + f"plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    return rows


def phase_k1_int8(torch, timer):
    """K1's int8 variant (the dense int8 policy): int8 operands, an exact
    int32 sum, the scale read from device memory."""
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    from repro_torch.core.gemm_spec import GemmSpec

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    # Granite's int8 GEMMs: every 2-D one but the f32 router.
    shapes = [("phi3", name, k, n, kind, act, False, per_step)
              for name, k, n, kind, act, per_step in MAIN_SHAPES]
    shapes += [("granite", f"g-{name}", k, n, "linear", None, trans_b,
                per_step)
               for name, k, n, dt, trans_b, per_step in GRANITE_2D_SHAPES
               if dt != "float32"]
    steps = {"phi3": StepSum(), "granite": StepSum()}
    for m in (2, 32):
        for model, name, k, n, kind, act, trans_b, per_step in shapes:
            step = steps[model]
            a = torch.randint(-127, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (n, k) if trans_b else (k, n),
                              generator=gen, device="cuda", dtype=torch.int8)
            # sx * sw of unit-variance data: outputs of order 1.
            scale = torch.full((), 3.0 / (127.0 * 127.0 * k ** 0.5),
                               device="cuda")
            extras = () if kind == "linear" else (
                torch.randn(m, n, generator=gen, device="cuda").to(bf16),)
            ep = EpilogueSpec(kind=kind, activation=act)
            a_lib, w_lib = a.to(bf16), w.to(bf16)   # exact: |q| <= 127

            def kern():
                return mpgemm(a, w, scale=scale, extras=extras, epilogue=ep,
                              spec=GemmSpec(trans_b=trans_b), out_dtype=bf16)

            def plain():
                return mpgemm_plain(a, w, scale=scale, extras=extras,
                                    trans_b=trans_b, epilogue=ep,
                                    out_dtype=bf16)

            def library():
                acc = torch.matmul(a_lib, w_lib.t() if trans_b else w_lib)
                return apply_epilogue(ep, acc.float(), scale=scale,
                                      extras=extras).to(bf16)

            (got, design), ref = _k1_design_of(kern), plain()
            torch.cuda.synchronize()
            if design != "wgmma":
                raise AssertionError(f"K1 int8 {name} m={m}: ran {design}")
            err = _check_close(torch, f"K1 int8 {name} m={m}", got, ref, tol)
            step.max_abs_err = max(step.max_abs_err, err)
            n_bytes = m * k + k * n + 2 * m * n * (1 + len(extras)) + 4
            n_ops = 2 * m * n * k
            bound, bound_by = _bound_ms(n_bytes, n_ops, "int8")
            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
            print(f"[k1-int8] {name:>7} {design} m={m:<3} k={k:<5} n={n:<6} "
                  f"trans_b={trans_b:d} {kind:>8}/{act}: err {err:.2e}  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library "
                  f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s")
            if m == 2:
                step.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                         n_ops)
    rows = {}
    for model, step in steps.items():
        row = rows[model] = step.row("int8")
        print(f"[k1-int8] one full-width {model} decode step (M=2, "
              f"{step.launches} int8 launches): kernel {row['ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms (bf16 matmul of the int8 values), "
              f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return rows


# ------------------------------------------------------------------ phase 3

def _paged_inputs(torch, gen, *, b, h, hkv, d, ps, w, tq, q_start, lengths,
                  dtype):
    """A pool with one private page run per request, dead slots pointing
    at a NaN-filled scratch page 0, and the tables/positions as int32."""
    n_pages = 1 + b * w
    k_pages = torch.randn(n_pages, hkv, ps, d, generator=gen,
                          device="cuda").to(dtype)
    v_pages = torch.randn(n_pages, hkv, ps, d, generator=gen,
                          device="cuda").to(dtype)
    k_pages[0] = float("nan")
    v_pages[0] = float("nan")
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).reshape(b, w)
    bt = torch.zeros(b, w, dtype=torch.int32, device="cuda")
    for i in range(b):
        used = -(-lengths[i] // ps)
        bt[i, :used] = perm[i, :used].to(torch.int32)
    q = torch.randn(b, h, tq, d, generator=gen, device="cuda").to(dtype)
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k_pages, v_pages, bt, qs, ln


def _attn_work(q_start, lengths, tq, h, hkv, d, window, esz):
    """(bytes, operations) this input needs: live K/V rows read once, q
    read and out written once; 4*D operations per unmasked (row, key)."""
    n_bytes = 2 * len(lengths) * h * tq * d * esz
    pairs = 0
    for qs, ln in zip(q_start, lengths):
        n_bytes += 2 * ln * hkv * d * esz
        for t in range(tq):
            qi = qs + t
            lo = max(0, qi - window + 1) if window else 0
            hi = min(ln - 1, qi)
            pairs += max(0, hi - lo + 1)
    return n_bytes, 4 * d * h * pairs


# K5's cases: the attention of the two served models at decode and in a
# 16-token prefill chunk, a windowed GQA head, and an f32 case.
K5_CASES = [
    # phi3-mini attention as phase 7 serves it: MHA, D = 96, page 16,
    # a block table 4 pages wide (max_len 64); request 2 is idle, and
    # in the prefill chunk request 1 has 7 dead rows past its length.
    dict(name="phi3-decode", h=32, hkv=32, d=96, ps=16, w=4, tq=1,
         lengths=[45, 30, 0], window=None, dtype="bfloat16"),
    dict(name="phi3-prefill16", h=32, hkv=32, d=96, ps=16, w=4, tq=16,
         lengths=[48, 9, 0], window=None, dtype="bfloat16"),
    # granite-moe-1b-a400m's attention as phase 7 serves it: GQA 2:1
    # (16 heads, 8 KV heads), D = 64, the same pages and lengths.
    dict(name="granite-decode", h=16, hkv=8, d=64, ps=16, w=4, tq=1,
         lengths=[45, 30, 0], window=None, dtype="bfloat16"),
    dict(name="granite-prefill16", h=16, hkv=8, d=64, ps=16, w=4,
         tq=16, lengths=[48, 9, 0], window=None, dtype="bfloat16"),
    # GQA 4:1, D = 120 (not a multiple of 16), window 64, ~200 context
    dict(name="gqa-window-decode", h=32, hkv=8, d=120, ps=16, w=16,
         tq=1, lengths=[201, 64, 0, 9], window=64, dtype="bfloat16"),
    dict(name="gqa-window-prefill16", h=32, hkv=8, d=120, ps=16, w=16,
         tq=16, lengths=[200, 70, 0, 16], window=64, dtype="bfloat16"),
    dict(name="f32-gqa-prefill16", h=8, hkv=2, d=64, ps=16, w=8, tq=16,
         lengths=[40, 100, 0, 3], window=None, dtype="float32"),
    # The other continuous paths, as phase 7 serves them (pages and
    # lengths as phi3's): starcoder2-3b GQA 12:1 (24 heads, 2 KV heads),
    # phi3-medium-14b 4:1 (40:10), mixtral-8x22b 6:1 (48:8) with its window
    # of 4096, all D = 128; and mixtral past its window, where the window
    # cuts the keys (block tables 288 pages wide, 4608 keys).
    dict(name="starcoder2-decode", h=24, hkv=2, d=128, ps=16, w=4, tq=1,
         lengths=[45, 30, 0], window=None, dtype="bfloat16"),
    dict(name="starcoder2-prefill16", h=24, hkv=2, d=128, ps=16, w=4,
         tq=16, lengths=[48, 9, 0], window=None, dtype="bfloat16"),
    dict(name="phi3-medium-decode", h=40, hkv=10, d=128, ps=16, w=4, tq=1,
         lengths=[45, 30, 0], window=None, dtype="bfloat16"),
    dict(name="phi3-medium-prefill16", h=40, hkv=10, d=128, ps=16, w=4,
         tq=16, lengths=[48, 9, 0], window=None, dtype="bfloat16"),
    dict(name="mixtral-decode", h=48, hkv=8, d=128, ps=16, w=4, tq=1,
         lengths=[45, 30, 0], window=4096, dtype="bfloat16"),
    dict(name="mixtral-prefill16", h=48, hkv=8, d=128, ps=16, w=4,
         tq=16, lengths=[48, 9, 0], window=4096, dtype="bfloat16"),
    dict(name="mixtral-window-decode", h=48, hkv=8, d=128, ps=16, w=288,
         tq=1, lengths=[4600, 4200, 0], window=4096, dtype="bfloat16"),
    dict(name="mixtral-window-prefill16", h=48, hkv=8, d=128, ps=16,
         w=288, tq=16, lengths=[4608, 4111, 0], window=4096,
         dtype="bfloat16"),
]
# Full-width depths of the served models whose K5 times phase_k5 sums.
K5_MODEL_LAYERS = {"phi3": 32, "granite": GRANITE_LAYERS,
                   "starcoder2": 30, "phi3-medium": 40,
                   "mixtral": MIXTRAL_LAYERS,
                   "mixtral-window": MIXTRAL_LAYERS}


def phase_k5(torch, timer):
    """K5 against its plain version at the served shapes, each case on
    the design ``k5_design`` names (bf16: "split" at most 16 folded rows,
    "wgmma" above; f32: "simt"), the same bits from two launches, live
    rows within bf16's tolerance and idle rows exactly 0, timed beside
    the plain version, SDPA and the bound; then one full-width decode step
    and one 16-token chunk of each model (a launch a layer)."""
    from repro_torch.kernels.flash_attention import (
        k5_split, paged_flash_attention, paged_flash_attention_plain,
    )
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    rows, max_err = [], 0.0
    for c in K5_CASES:
        c = dict(c, dtype=getattr(torch, c["dtype"]))
        b, tq = len(c["lengths"]), c["tq"]
        # Every live request's last tq tokens are this chunk (a chunk
        # shorter than tq leaves dead rows past the length).
        q_start = [max(0, ln - tq) if ln else 0 for ln in c["lengths"]]
        q, kp, vp, bt, qs, ln = _paged_inputs(
            torch, gen, b=b, h=c["h"], hkv=c["hkv"], d=c["d"], ps=c["ps"],
            w=c["w"], tq=tq, q_start=q_start, lengths=c["lengths"],
            dtype=c["dtype"])
        kw = dict(causal=True, window=c["window"])

        def kern():
            return paged_flash_attention(q, kp, vp, bt, qs, ln, **kw)

        def plain():
            return paged_flash_attention_plain(q, kp, vp, bt, qs, ln, **kw)

        # Library yardstick: SDPA over K/V gathered beforehand (the gather
        # is not timed), with the same boolean mask.
        s_max = c["w"] * c["ps"]
        kd = kp[bt.long()].transpose(1, 2).reshape(b, c["hkv"], s_max, c["d"])
        vd = vp[bt.long()].transpose(1, 2).reshape(b, c["hkv"], s_max, c["d"])
        g = c["h"] // c["hkv"]
        kd, vd = (kd.repeat_interleave(g, dim=1),
                  vd.repeat_interleave(g, dim=1))
        ki = torch.arange(s_max, device="cuda")
        qi = qs.long()[:, None] + torch.arange(tq, device="cuda")[None]
        mask = (ki[None, None] < ln.long()[:, None, None]) & \
            (ki[None, None] <= qi[:, :, None])
        if c["window"]:
            mask &= ki[None, None] > qi[:, :, None] - c["window"]
        mask = mask[:, None]

        def library():
            return F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask)

        (got, design), ref = _k5_design_of(kern), plain()
        torch.cuda.synchronize()
        g_tq = c["h"] // c["hkv"] * tq
        want = ("simt" if c["dtype"] != bf16 else
                "split" if g_tq <= 16 else "wgmma")
        if design != want:
            raise AssertionError(f"K5 {c['name']}: ran the {design} design, "
                                 f"want {want}")
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K5 {c['name']}: two launches differ")
        del again
        # Compare the live rows (position < length) and the idle rows
        # (length 0, both 0); dead rows past the length are padding.
        live = (qi < ln.long()[:, None]) | (ln.long()[:, None] == 0)
        sel = live[:, None, :, None].expand_as(got)
        gl, rl = got.float()[sel], ref.float()[sel]
        err = (gl - rl).abs().max().item()
        tol = TOL[_dtype_name(c["dtype"])]
        if not torch.allclose(gl, rl, **tol) or \
                not torch.isfinite(got.float()[sel]).all():
            raise AssertionError(
                f"K5 {c['name']}: max |kernel - plain| = {err:.3e} beyond "
                f"rtol={tol['rtol']}, atol={tol['atol']}")
        if got.float()[:, :, :, :][ln.long() == 0].abs().max().item() != 0:
            raise AssertionError(f"K5 {c['name']}: idle row is not zero")
        max_err = max(max_err, err)
        n_bytes, n_ops = _attn_work(q_start, c["lengths"], tq, c["h"],
                                    c["hkv"], c["d"], c["window"],
                                    q.element_size())
        bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(c["dtype"]))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        row = dict(case=c["name"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   design=design)
        rows.append(row)
        slices = (k5_split(g_tq, c["w"], c["ps"], b, c["hkv"])
                  if design != "simt" else 1)
        print(f"[k5] {c['name']:>20} {design:>5} x{slices:<2} "
              f"H={c['h']} Hkv={c['hkv']} D={c['d']} "
              f"tq={tq} lengths={c['lengths']} window={c['window']}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.5f} ({bound_by})")
    # Per full-width decode step (and 16-token chunk): one launch per layer
    # of the model's case, as the K1 numbers are one decode step's GEMM
    # launches.
    by_name = {r["case"]: r for r in rows}
    steps = {}
    for model, layers in K5_MODEL_LAYERS.items():
        for key, case, what in ((model, f"{model}-decode", "decode step"),
                                (f"{model}-chunk", f"{model}-prefill16",
                                 "16-token chunk")):
            r = by_name[case]
            step = steps[key] = {k: layers * r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms")}
            step.update(bound_by=r["bound_by"], max_abs_err=max_err)
            print(f"[k5] one full-width {model} {what} ({layers} launches "
                  f"of {case}, {r['design']}): kernel {step['ms']:.3f} ms, "
                  f"plain {step['plain_ms']:.3f} ms, library "
                  f"{step['library_ms']:.3f} ms, bound "
                  f"{step['bound_ms']:.4f} ms ({step['bound_by']})")
    return steps, rows


# ----------------------------------------------------------------- phase 3b

# K4 cases: (name, B, H, Hkv, tq, tk, D, causal, window, dtype, model use).
# Whisper-medium (16 MHA heads of 64) as the wave path runs it: the
# encoder's non-causal self-attention over 1500 frames (not a multiple of
# the kernel's 32-key chunk), the decoder's causal self-attention at a
# 32-token prefill, its cross-attention over the encoder states at prefill
# and at every decode step; phi3-mini's causal prefill (32 heads of 96); a
# danube3-like GQA 32:8 head of 120 with a window shorter than tk and
# tq < tk; f32 cases: two on K4's tf32x3 design, one of 16 folded rows on
# its first scalar kernel, which k4_design keeps for so few rows.
K4_CASES = [
    ("whisper-encoder", 2, 16, 16, 1500, 1500, 64, False, None, "bfloat16"),
    ("whisper-dec-self", 2, 16, 16, 32, 32, 64, True, None, "bfloat16"),
    ("whisper-cross", 2, 16, 16, 32, 1500, 64, False, None, "bfloat16"),
    ("whisper-decode-cross", 2, 16, 16, 1, 1500, 64, False, None,
     "bfloat16"),
    ("phi3-prefill", 2, 32, 32, 32, 32, 96, True, None, "bfloat16"),
    ("gqa-window", 2, 32, 8, 64, 600, 120, True, 256, "bfloat16"),
    ("f32-gqa", 2, 8, 2, 48, 300, 64, True, None, "float32"),
    ("f32-gqa-16-rows", 2, 8, 2, 4, 300, 64, True, None, "float32"),
    # granite's attention in an fp32 training step (batch 4 x seq 128,
    # GQA 16:8, D 64, causal): K4's tf32x3 design.
    ("granite-train-f32", 4, 16, 8, 128, 128, 64, True, None, "float32"),
    # llama-3.2-vision-11b on the wave path (GQA 32:8, D 128): the causal
    # self-attention of a 32-token prefill, the cross-attention over its
    # 1600 image keys at that prefill and at a decode step.
    ("vision-prefill", 2, 32, 8, 32, 32, 128, True, None, "bfloat16"),
    ("vision-cross", 2, 32, 8, 32, 1600, 128, False, None, "bfloat16"),
    ("vision-decode-cross", 2, 32, 8, 1, 1600, 128, False, None,
     "bfloat16"),
    # recurrentgemma-2b's local attention (MQA 10:1, D 256, window 2048):
    # a 32-token prefill, a prefill the window cuts, and one query row
    # over a full ring cache of 2048 slots -- D > K4_MAX_D, so the first
    # scalar kernel by the rule.
    ("rgemma-prefill", 2, 10, 1, 32, 32, 256, True, 2048, "bfloat16"),
    ("rgemma-window", 1, 10, 1, 2560, 2560, 256, True, 2048, "bfloat16"),
    ("rgemma-ring", 2, 10, 1, 1, 2048, 256, False, None, "bfloat16"),
    # The forward launches of the cross and recurrent kinds' training
    # paths (batch 4 x seq 128): llama-vision's causal self-attention and
    # its cross-attention over the 1600 image rows; recurrentgemma's local
    # attention at D 256 (the first scalar kernel by the rule).
    ("vision-train-self", 4, 32, 8, 128, 128, 128, True, None, "bfloat16"),
    ("vision-train-cross", 4, 32, 8, 128, 1600, 128, False, None,
     "bfloat16"),
    ("rgemma-train", 4, 10, 1, 128, 128, 256, True, 2048, "bfloat16"),
]
WHISPER_LAYERS = 24
PHI3_LAYERS = 32
VISION_LAYERS, VISION_CROSS = 40, 8       # llama-vision: 8 cross of 40
RGEMMA_LOCAL = 8                          # recurrentgemma: local attention


def _k4_pairs(tq, tk, causal, window):
    """(query row, key) pairs one head sees: the work K4 must do."""
    pairs = 0
    for t in range(tq):
        qi = t + tk - tq
        hi = min(tk - 1, qi) if causal else tk - 1
        lo = max(0, qi - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def _k4_scalar(torch, q, k, v, causal, window):
    """K4's first scalar kernel (``csrc/flash_attention.cu``) on q, k and v
    through its C entry point, whatever design ``k4_design`` picks: held
    against the plain version in every f32 case, and the "was" of the
    cases its tf32x3 design took over."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import _DTYPE_CODES, _flash_lib

    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _flash_lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv,
        tq, tk, d, int(causal), int(window or 0), float(d ** -0.5),
        _DTYPE_CODES[q.dtype], _build.current_stream(q))
    if rc:
        raise AssertionError(f"the scalar K4 kernel failed: CUDA error {rc}")
    return out


def phase_k4(torch, timer):
    """K4 against its plain version at the wave path's shapes, each launch
    timed alone on a cold L2, beside the plain version, SDPA (K/V repeated
    for GQA beforehand, not timed) and the bound; each case names the
    design ``k4_design`` ran (bf16: "wgmma" or "split" at most 16 folded
    rows; f32: "tf32x3", or "simt" at most 16 folded rows) and the slices
    over the keys (``k4_split``); every f32 case also holds the first
    scalar kernel (``_k4_scalar``) against the plain version on its inputs
    and times it (``scalar_ms``).
    SDPA gets no mask where every key is visible, ``is_causal`` for a
    causal square without a window (both keep its flash backend open),
    else the explicit mask.  A tf32x3 case's bound divides its operations
    by the tf32 tensor cores' peak (``_peak_of``)."""
    from repro_torch.kernels.flash_attention import (
        _attention_mask, flash_attention, flash_attention_plain, k4_design,
        k4_split,
    )
    F = torch.nn.functional
    rng = np.random.default_rng(5)
    rows = {}
    for name, b, h, hkv, tq, tk, d, causal, window, dt in K4_CASES:
        dtype = getattr(torch, dt)

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(device="cuda", dtype=dtype)

        q, k, v = rand(b, h, tq, d), rand(b, hkv, tk, d), rand(b, hkv, tk, d)
        kw = dict(causal=causal, window=window)
        g = h // hkv
        kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        if not causal and window is None:
            sdpa = dict()
        elif causal and window is None and tq == tk:
            sdpa = dict(is_causal=True)
        else:
            sdpa = dict(attn_mask=_attention_mask(tq, tk, causal, window,
                                                  q.device))

        def kern():
            return flash_attention(q, k, v, **kw)

        def plain():
            return flash_attention_plain(q, k, v, **kw)

        def library():
            return F.scaled_dot_product_attention(q, kr, vr, **sdpa)

        (got, design), ref = _k4_design_of(kern), plain()
        torch.cuda.synchronize()
        small = g * tq <= 16
        want = ("simt" if d > _k4_max_d() else
                ("simt" if small else "tf32x3") if dt == "float32" else
                "split" if small else "wgmma")
        if design != want or design != k4_design(q, k, v):
            raise AssertionError(f"K4 {name}: ran the {design} design")
        again = kern()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K4 {name}: two launches differ")
        del again
        tol = TOL[dt]
        err = _check_close(torch, f"K4 {name}", got, ref, tol)
        esz = q.element_size()
        n_bytes = 2 * q.numel() * esz + 2 * k.numel() * esz
        n_ops = 4 * b * h * d * _k4_pairs(tq, tk, causal, window)
        bound, bound_by = _bound_ms(n_bytes, n_ops, _peak_of(design, dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound,
                          bound_by=bound_by, bytes=n_bytes, ops=n_ops)
        was = ""
        if dt == "float32":
            scalar = _k4_scalar(torch, q, k, v, causal, window)
            torch.cuda.synchronize()
            s_err = _check_close(torch, f"K4 {name} scalar kernel", scalar,
                                 ref, tol)
            del scalar
            rows[name]["scalar_ms"] = timer(
                lambda: _k4_scalar(torch, q, k, v, causal, window))
            was = (f"  scalar kernel {rows[name]['scalar_ms']:.4f} (err "
                   f"{s_err:.2e})")
        slices = (k4_split(g * tq, tk, b, hkv) if design in ("wgmma", "split")
                  else 1)
        print(f"[k4] {name:>20} {dt:>8} {design:>5} x{slices:<2} B={b} "
              f"H={h} Hkv={hkv} D={d} "
              f"tq={tq} tk={tk} causal={causal:d} window={window}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library (SDPA) "
              f"{lib_ms:.4f} {sdpa and next(iter(sdpa)) or 'no mask'}  "
              f"bound {bound:.4f} ({bound_by})  "
              f"{n_ops / ms / 1e9:.1f} TFLOP/s{was}")

    def total(label, parts, peak="bfloat16"):
        """Times of the launches ``parts`` = {case: launches} summed."""
        keys = ["ms", "plain_ms", "library_ms", "bound_ms"]
        if all("scalar_ms" in rows[c] for c in parts):
            keys.append("scalar_ms")
        out = {key: sum(n * rows[c][key] for c, n in parts.items())
               for key in keys}
        n_bytes = sum(n * rows[c]["bytes"] for c, n in parts.items())
        n_ops = sum(n * rows[c]["ops"] for c, n in parts.items())
        out["bound_by"] = _bound_ms(n_bytes, n_ops, peak)[1]
        out["max_abs_err"] = max(rows[c]["max_abs_err"] for c in parts)
        print(f"[k4] {label} ({sum(parts.values())} launches): kernel "
              f"{out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, library "
              f"{out['library_ms']:.3f} ms, bound {out['bound_ms']:.4f} ms "
              f"({out['bound_by']})")
        return out

    L = WHISPER_LAYERS
    return {
        "whisper-prefill": total(
            "one whisper-medium prefill of 32 tokens",
            {"whisper-encoder": L, "whisper-dec-self": L,
             "whisper-cross": L}),
        "whisper-decode": total("one whisper-medium decode step",
                                {"whisper-decode-cross": L}),
        "phi3-prefill": total("one phi3-mini wave prefill of 32 tokens",
                              {"phi3-prefill": PHI3_LAYERS}),
        "granite-train-f32": total(
            "the forward and remat launches of one full-depth granite fp32 "
            "training step", {"granite-train-f32": 2 * GRANITE_LAYERS},
            "tfloat32"),
        "vision-prefill": total(
            "one llama-3.2-vision-11b wave prefill of 32 tokens",
            {"vision-prefill": VISION_LAYERS - VISION_CROSS,
             "vision-cross": VISION_CROSS}),
        "vision-decode": total("one llama-3.2-vision-11b decode step",
                               {"vision-decode-cross": VISION_CROSS}),
        "rgemma-prefill": total(
            "one recurrentgemma-2b wave prefill of 32 tokens",
            {"rgemma-prefill": RGEMMA_LOCAL}),
        "vision-train": total(
            "the forward and remat launches of one llama-3.2-vision-11b "
            "training step at 5 layers (4 dense, 1 cross)",
            {"vision-train-self": 2 * 4, "vision-train-cross": 2}),
        "rgemma-train": total(
            "the forward and remat launches of one recurrentgemma-2b "
            "training step at 5 layers (1 local attention)",
            {"rgemma-train": 2}),
    }


# ------------------------------------------------------------------ phase 4

PAYLOADS = ("bfloat16", "int8", "int4", "fp8e4m3")


def _pack_rule(name):
    """The design rule ``name`` of ``packing/pack.py`` (``k6_design``,
    ``k7_design``), or None on a tree without it (chip_ab.py runs these
    phases on older trees, whose kernels are all "simt")."""
    from repro_torch.packing import pack
    return getattr(pack, name, None)


def _stream_design_of(call, key):
    """Run ``call`` (one K6 or K7 launch: ``key`` "k6" or "k7") -> (its
    output, "stream" or "simt", read off the counters)."""
    return _design_of(call, (key,), ("stream",))


def _k6_scalar(torch, w, layout):
    """K6's first, scalar kernel (``csrc/pack.cu::pack_kernel``, the
    "simt" design) on ``w`` through its C entry point, whatever design
    the wrapper would pick -> (payload, scales)."""
    from repro_torch.kernels import _build
    from repro_torch.packing import pack as pk
    payload = torch.empty(layout.payload_shape, dtype=layout.storage_dtype,
                          device=w.device)
    scales = (torch.empty(layout.scales_shape, dtype=torch.float32,
                          device=w.device)
              if layout.per_tile_scales else None)
    lib = pk._lib()
    rc = lib.pack_launch(
        w.data_ptr(), payload.data_ptr(),
        None if scales is None else scales.data_ptr(),
        pk._SRC_CODES[w.dtype], pk._PAYLOAD_CODES[layout.dtype], layout.g,
        layout.k, layout.n, layout.bk, layout.bn, int(layout.trans_w),
        _build.current_stream(w))
    if rc:
        raise RuntimeError(f"K6 scalar kernel: CUDA error {rc} "
                           f"({lib.pack_error_string(rc).decode()})")
    return payload, scales


def _k7_scalar(torch, p, dtype):
    """K7's first, scalar kernel (``csrc/pack.cu::unpack_kernel``) on the
    packed ``p`` through its C entry point -> the dense operand."""
    from repro_torch.kernels import _build
    from repro_torch.packing import pack as pk
    layout = p.layout
    shape = ((layout.g,) if layout.g != 1 else ()) + (layout.k, layout.n)
    out = torch.empty(shape, dtype=dtype, device=p.payload.device)
    lib = pk._lib()
    rc = lib.unpack_launch(
        p.payload.data_ptr(),
        p.scales.data_ptr() if layout.per_tile_scales else None,
        out.data_ptr(), pk._PAYLOAD_CODES[layout.dtype],
        pk._OUT_CODES[dtype], layout.g, layout.k, layout.n, layout.bk,
        layout.bn, _build.current_stream(p.payload))
    if rc:
        raise RuntimeError(f"K7 scalar kernel: CUDA error {rc} "
                           f"({lib.pack_error_string(rc).decode()})")
    return out


def _same_pack(torch, got, want):
    """Payload and scales byte for byte (``got``, ``want``: (payload,
    scales) pairs)."""
    ok = torch.equal(got[0].contiguous().view(torch.uint8),
                     want[0].contiguous().view(torch.uint8))
    if want[1] is not None:
        ok = ok and torch.equal(got[1].view(torch.int32),
                                want[1].view(torch.int32))
    return ok


def _k6_case(torch, timer, label, w, blocks, trans_w, fmt, want_design):
    """One K6 case: the wrapper's launch (its design read off the
    counters, which must be ``k6_design``'s, and ``want_design`` where
    given) and the scalar kernel, both byte-equal to the plain version;
    each timed -> (layout, design, ms, scalar_ms, plain_ms, bound_ms,
    bound_by, bytes)."""
    from repro_torch.packing.pack import _layout_for, pack_operand, \
        pack_reference

    def kern():
        return pack_operand(w, blocks, trans_w=trans_w, dtype=fmt)

    layout = _layout_for(w, *blocks, trans_w=trans_w, dtype=fmt)
    rule = _pack_rule("k6_design")
    got, design = _stream_design_of(kern, "k6")
    if design != (rule(w, layout) if rule else "simt") or (
            rule and want_design not in (None, design)):
        raise AssertionError(f"K6 {label} {fmt}: ran the {design} design")

    def plain():
        return pack_reference(w, layout)

    def scalar():
        return _k6_scalar(torch, w, layout)

    want, old = plain(), scalar()
    torch.cuda.synchronize()
    if not _same_pack(torch, (got.payload, got.scales), want):
        raise AssertionError(f"K6 {label} {fmt}: the {design} design's "
                             "payload or scales differ from the plain "
                             "version")
    if not _same_pack(torch, old, want):
        raise AssertionError(f"K6 {label} {fmt}: the scalar kernel's "
                             "payload or scales differ from the plain "
                             "version")
    n_bytes = w.numel() * w.element_size() + got.nbytes
    bound, bound_by = _bound_ms(n_bytes, 0, "float32")
    ms, scalar_ms, plain_ms = timer(kern), timer(scalar), timer(plain)
    return layout, design, ms, scalar_ms, plain_ms, bound, bound_by, n_bytes


def phase_k6(torch, timer):
    """K6 against its plain version: byte-equal payload and scales, on the
    design ``k6_design`` picks (every phi3-mini weight: "stream") and on
    the scalar kernel (the "was" column, ``_k6_scalar``); a case of its
    own ("simt-pitch": rows of 12008 bytes) runs the scalar kernel
    through the wrapper.  Each pack timed against its bytes bound (source
    read once, payload and scales written once)."""
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(5)
    # (name, source shape, trans_w, packs per full-width model, design)
    shapes = [(name, (k, n), False, per_step, "stream")
              for name, k, n, _, _, per_step in MAIN_SHAPES if name != "gate"]
    shapes = [(nm, sh, tw, 2 * c if nm == "up" else c, d)
              for nm, sh, tw, c, d in shapes]       # up and gate: one shape
    shapes += [("ragged-trans_w", (1000, 3000), True, 0, "stream"),
               ("simt-pitch", (1000, 3002), False, 0, "simt")]
    model = {fmt: StepSum() for fmt in PAYLOADS}
    for name, shape, trans_w, per_model, want in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * \
            (2.0 / sum(shape)) ** 0.5
        k, n = shape[::-1] if trans_w else shape
        for fmt in PAYLOADS:
            (layout, design, ms, scalar_ms, plain_ms, bound, bound_by,
             n_bytes) = _k6_case(torch, timer, name, w, default_blocks(k, n),
                                 trans_w, fmt, want)
            print(f"[k6] {name:>14} {str(shape):>13} trans_w={trans_w:d} "
                  f"-> {fmt:>8} {tuple(layout.payload_shape)} {design:>6}: "
                  f"byte-equal  kernel {ms:.4f} ms  scalar kernel "
                  f"{scalar_ms:.4f}  plain {plain_ms:.4f}  bound "
                  f"{bound:.4f} ({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s "
                  f"({100 * bound / ms:.0f} % of the bound)")
            model[fmt].add(per_model, ms, plain_ms, 0.0, bound, n_bytes, 0,
                           scalar_ms)
    rows = {}
    for fmt, acc in model.items():
        rows[fmt] = acc.row("float32")
        print(f"[k6] packing a full-width phi3-mini ({acc.launches} weights) "
              f"into {fmt}: kernel {acc.ms:.3f} ms, scalar kernel "
              f"{acc.scalar_ms:.3f} ms, plain {acc.plain_ms:.3f} ms, bound "
              f"{acc.bound_ms:.3f} ms")
    return rows


# ------------------------------------------------------------------ phase 5

# (policy, payload): what ``mp_dot`` hands K2 under each policy.  Under
# int8, an fp8 payload takes bf16 A (the bf16 rows cover it) and a bf16
# payload is not a K2 path (it is unpacked and re-quantized per tensor).
K2_COMBOS = [("bf16", "bfloat16"), ("bf16", "int8"), ("bf16", "int4"),
             ("bf16", "fp8e4m3"), ("int8", "int8"), ("int8", "int4")]
# The two packed paths that chip_smoke serves: int4 under bf16, int8 under
# int8.
SERVED_K2_COMBOS = [("bf16", "int4"), ("int8", "int8")]


def phase_k2(torch, timer):
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import mpgemm_packed, \
        mpgemm_packed_plain
    from repro_torch.packing.pack import pack_operand, unpack_reference
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    # phi3's GEMMs under every combination; granite's packed attention
    # projections (its only 2-D K2 launches: 96 per step) under the two
    # served ones.
    shapes = [("phi3", name, k, n, kind, act, per_step, K2_COMBOS)
              for name, k, n, kind, act, per_step in MAIN_SHAPES]
    shapes += [("granite", f"g-{name}", k, n, "linear", None, per_step,
                SERVED_K2_COMBOS)
               for name, k, n, dt, _, per_step in GRANITE_2D_SHAPES
               if name in ("wq/wo", "wk/wv")]
    steps = {(model, c): StepSum() for model, *_, combos in shapes
             for c in combos}
    for model, name, k, n, kind, act, per_step, combos in shapes:
        w = torch.randn(k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        packed = {fmt: pack_operand(w, default_blocks(k, n), dtype=fmt)
                  for fmt in {fmt for _, fmt in combos}}
        # The library yardstick's weight, dequantized beforehand.
        w_lib = {fmt: unpack_reference(p.payload, p.scales, p.layout,
                                       "bfloat16")
                 for fmt, p in packed.items()}
        ep = EpilogueSpec(kind=kind, activation=act)
        for m in (2, 32):
            x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
            xq, sx = quantize_per_tensor(x)
            extras = () if kind == "linear" else (
                torch.randn(m, n, generator=gen, device="cuda").to(bf16),)
            for policy, fmt in combos:
                b = packed[fmt]
                a, scale = (xq, sx) if policy == "int8" else (x, None)
                kw = dict(scale=scale, extras=extras, epilogue=ep,
                          out_dtype=bf16)

                def kern():
                    return mpgemm_packed(a, b, **kw)

                def plain():
                    return mpgemm_packed_plain(a, b, **kw)

                def library():
                    acc = torch.matmul(x, w_lib[fmt])
                    return apply_epilogue(ep, acc.float(),
                                          extras=extras).to(bf16)

                (got, design), ref = _k2_design_of(kern), plain()
                torch.cuda.synchronize()
                if design != "wgmma":
                    raise AssertionError(f"K2 {name} m={m} {policy}/{fmt}: "
                                         f"ran the {design} design")
                again = kern()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K2 {name} m={m} {policy}/{fmt}: "
                                         f"two launches differ")
                del again
                err = _check_close(torch, f"K2 {name} m={m} {policy}/{fmt}",
                                   got, ref, tol)
                st = steps[(model, (policy, fmt))]
                st.max_abs_err = max(st.max_abs_err, err)
                n_bytes = (b.nbytes + a.numel() * a.element_size()
                           + 2 * m * n * (1 + len(extras)))
                n_ops = 2 * m * n * k
                peak = "int8" if policy == "int8" else "bfloat16"
                bound, bound_by = _bound_ms(n_bytes, n_ops, peak)
                ms, plain_ms, lib_ms = (timer(kern), timer(plain),
                                        timer(library))
                print(f"[k2] {name:>5} m={m:<3} {policy:>4} A x {fmt:>8} "
                      f"{design}: err {err:.2e}  kernel {ms:.4f} ms  plain "
                      f"{plain_ms:.4f}  library {lib_ms:.4f}  bound "
                      f"{bound:.4f} ({bound_by})  "
                      f"{n_bytes / ms / 1e6:.1f} GB/s")
                if m == 2:
                    st.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                           n_ops)
    x = torch.randn(2, 3072, generator=gen, device="cuda").to(bf16)
    q_ms = timer(lambda: quantize_per_tensor(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        quantize_per_tensor(x)
    host_ms = 10.0 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    print(f"[k2] quantize_per_tensor of a (2, 3072) activation, the int8 "
          f"policy's per-GEMM prologue: {q_ms:.4f} ms on the device, "
          f"{host_ms:.4f} ms of host time to enqueue")
    rows = {}
    for (model, (policy, fmt)), st in steps.items():
        row = rows[(model, (policy, fmt))] = st.row(
            "int8" if policy == "int8" else "bfloat16")
        print(f"[k2] one full-width {model} decode step, {policy} A x {fmt} "
              f"(M=2, {st.launches} launches): kernel {row['ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})")
    return rows


# ------------------------------------------------------------------ phase 6

# granite-moe-1b-a400m's expert GEMMs, one grouped launch over its 32
# experts each: (name, K, N, epilogue kind, activation, launches per
# full-width decode step).  Decode gives each expert M = 2 rows (capacity 1
# per sequence, 2 sequences); a 16-token prefill chunk gives M = 32.
GRANITE_EXPERTS = 32
GROUPED_SHAPES = [
    ("up", 1024, 512, "linear", None, 24),
    ("gate", 1024, 512, "gated", "silu", 24),
    ("down", 512, 1024, "linear", None, 24),
]


def phase_k1_grouped(torch, timer):
    """Grouped K1 at granite's expert shapes: bf16 A (the bf16 policy) and
    int8 A (the int8 policy: one scale for the whole buffer and stack), f32
    outputs, the SwiGLU gate fused into the gate GEMM's store."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm_grouped, \
        mpgemm_grouped_plain

    gen = torch.Generator(device="cuda").manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    g = GRANITE_EXPERTS
    steps = {"bfloat16": StepSum(), "int8": StepSum()}
    for dt_name, step in steps.items():
        for name, k, n, kind, act, per_step in GROUPED_SHAPES:
            for m in (2, 32):
                if dt_name == "int8":
                    a = torch.randint(-127, 128, (g, m, k), generator=gen,
                                      device="cuda", dtype=torch.int8)
                    w = torch.randint(-127, 128, (g, k, n), generator=gen,
                                      device="cuda", dtype=torch.int8)
                    scale = torch.full((), 3.0 / (127.0 * 127.0 * k ** 0.5),
                                       device="cuda")
                else:
                    a = torch.randn(g, m, k, generator=gen,
                                    device="cuda").to(bf16)
                    w = (torch.randn(g, k, n, generator=gen, device="cuda")
                         * (2.0 / (k + n)) ** 0.5).to(bf16)
                    scale = None
                extras = () if kind == "linear" else (
                    torch.randn(g, m, n, generator=gen, device="cuda"),)
                ep = EpilogueSpec(kind=kind, activation=act)
                a_lib, w_lib = a.to(bf16), w.to(bf16)  # exact for |q| <= 127
                kw = dict(scale=scale, extras=extras, epilogue=ep,
                          out_dtype=f32)

                def kern():
                    return mpgemm_grouped(a, w, spec=GemmSpec(grouped=True),
                                          **kw)

                def plain():
                    return mpgemm_grouped_plain(a, w, **kw)

                def library():
                    acc = torch.bmm(a_lib, w_lib)
                    return apply_epilogue(ep, acc.float(), scale=scale,
                                          extras=extras)

                (got, design), ref = _k1_design_of(kern), plain()
                torch.cuda.synchronize()
                if design != "wgmma":
                    raise AssertionError(f"grouped K1 {dt_name} {name} "
                                         f"m={m}: ran {design}")
                err = _check_close(torch, f"grouped K1 {dt_name} {name} "
                                   f"m={m}", got, ref, TOL["float32"])
                step.max_abs_err = max(step.max_abs_err, err)
                n_bytes = (g * (m * k + k * n) * a.element_size()
                           + 4 * g * m * n * (1 + len(extras)) + 4)
                n_ops = 2 * g * m * n * k
                bound, bound_by = _bound_ms(n_bytes, n_ops, dt_name)
                ms, plain_ms, lib_ms = timer(kern), timer(plain), \
                    timer(library)
                print(f"[k1-grouped] {dt_name:>8} {design:>5} {name:>4} "
                      f"G={g} m={m:<3} "
                      f"k={k:<5} n={n:<5} {kind:>6}/{act}: err {err:.2e}  "
                      f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library "
                      f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
                      f"{n_bytes / ms / 1e6:.1f} GB/s")
                if m == 2:
                    step.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                             n_ops)
    rows = {}
    for dt_name, step in steps.items():
        row = rows[dt_name] = step.row(dt_name)
        print(f"[k1-grouped] one full-width granite decode step, {dt_name} "
              f"(M=2 per expert, {step.launches} launches): kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms (torch.bmm + epilogue), bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return rows


# (policy, payload) pairs of grouped K2: the served int4 (bf16 policy) and
# int8 (int8 policy) payloads, and a bf16 payload.
K2G_COMBOS = [("bf16", "int4"), ("bf16", "bfloat16"), ("int8", "int8")]


def phase_k2_grouped(torch, timer):
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import mpgemm_packed_grouped, \
        mpgemm_packed_grouped_plain
    from repro_torch.packing.pack import pack_operand, unpack_reference
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(8)
    f32, bf16, tol = torch.float32, torch.bfloat16, TOL["float32"]
    g = GRANITE_EXPERTS
    steps = {c: StepSum() for c in K2G_COMBOS}
    for name, k, n, kind, act, per_step in GROUPED_SHAPES:
        w = torch.randn(g, k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        ep = EpilogueSpec(kind=kind, activation=act)
        for policy, fmt in K2G_COMBOS:
            b = pack_operand(w, default_blocks(k, n), dtype=fmt)
            # The library yardstick's weight, dequantized beforehand.
            w_lib = unpack_reference(b.payload, b.scales, b.layout,
                                     "bfloat16")
            for m in (2, 32):
                x = torch.randn(g, m, k, generator=gen,
                                device="cuda").to(bf16)
                xq, sx = quantize_per_tensor(x)
                a, scale = (xq, sx) if policy == "int8" else (x, None)
                extras = () if kind == "linear" else (
                    torch.randn(g, m, n, generator=gen, device="cuda"),)
                kw = dict(scale=scale, extras=extras, epilogue=ep,
                          out_dtype=f32)

                def kern():
                    return mpgemm_packed_grouped(a, b, **kw)

                def plain():
                    return mpgemm_packed_grouped_plain(a, b, **kw)

                def library():
                    acc = torch.bmm(x, w_lib)
                    return apply_epilogue(ep, acc.float(), extras=extras)

                (got, design), ref = _k2_design_of(kern), plain()
                torch.cuda.synchronize()
                if design != "wgmma":
                    raise AssertionError(f"grouped K2 {name} m={m} "
                                         f"{policy}/{fmt}: ran {design}")
                again = kern()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"grouped K2 {name} m={m} "
                                         f"{policy}/{fmt}: two launches "
                                         f"differ")
                del again
                err = _check_close(torch, f"grouped K2 {name} m={m} "
                                   f"{policy}/{fmt}", got, ref, tol)
                st = steps[(policy, fmt)]
                st.max_abs_err = max(st.max_abs_err, err)
                n_bytes = (b.nbytes + a.numel() * a.element_size()
                           + 4 * g * m * n * (1 + len(extras)))
                n_ops = 2 * g * m * n * k
                peak = "int8" if policy == "int8" else "bfloat16"
                bound, bound_by = _bound_ms(n_bytes, n_ops, peak)
                ms, plain_ms, lib_ms = (timer(kern), timer(plain),
                                        timer(library))
                print(f"[k2-grouped] {name:>4} G={g} m={m:<3} {policy:>4} A x "
                      f"{fmt:>8} {design}: err {err:.2e}  kernel {ms:.4f} ms  "
                      f"plain "
                      f"{plain_ms:.4f}  library {lib_ms:.4f}  bound "
                      f"{bound:.4f} ({bound_by})  "
                      f"{n_bytes / ms / 1e6:.1f} GB/s")
                if m == 2:
                    st.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                           n_ops)
    rows = {}
    for (policy, fmt), st in steps.items():
        row = rows[(policy, fmt)] = st.row(
            "int8" if policy == "int8" else "bfloat16")
        print(f"[k2-grouped] one full-width granite decode step, {policy} A "
              f"x {fmt} (M=2 per expert, {st.launches} launches): kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})")
    return rows


def phase_k6_grouped(torch, timer):
    """K6 packing granite at full width: each weight shape (attention
    projections 2-D, expert stacks grouped in one launch) on the design
    ``k6_design`` picks ("stream" for all) and on the scalar kernel, both
    timed and byte-equal to the plain version, summed over the model;
    then every one of the model's 72 expert stacks, freshly drawn, packed
    into int4 and checked byte for byte."""
    from repro_torch.packing.pack import pack_operand, pack_reference
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(9)
    g, layers = GRANITE_EXPERTS, 24
    # (name, source shape, packs per full-width model)
    shapes = [("wq/wo", (1024, 1024), 2 * layers),
              ("wk/wv", (1024, 512), 2 * layers),
              ("experts up/gate", (g, 1024, 512), 2 * layers),
              ("experts down", (g, 512, 1024), layers)]
    model = {fmt: StepSum() for fmt in PAYLOADS}
    for name, shape, per_model in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * \
            (2.0 / sum(shape[-2:])) ** 0.5
        k, n = shape[-2:]
        for fmt in PAYLOADS:
            (layout, design, ms, scalar_ms, plain_ms, bound, bound_by,
             n_bytes) = _k6_case(torch, timer, f"granite {name}", w,
                                 default_blocks(k, n), False, fmt, "stream")
            print(f"[k6-grouped] {name:>15} {str(shape):>16} -> {fmt:>8} "
                  f"{tuple(layout.payload_shape)} {design:>6}: byte-equal  "
                  f"kernel {ms:.4f} ms  scalar kernel {scalar_ms:.4f}  plain "
                  f"{plain_ms:.4f}  bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s ({100 * bound / ms:.0f} % "
                  f"of the bound)")
            model[fmt].add(per_model, ms, plain_ms, 0.0, bound, n_bytes, 0,
                           scalar_ms)
    t0 = time.perf_counter()
    for i in range(3 * layers):
        k, n = (512, 1024) if i % 3 == 2 else (1024, 512)
        w = torch.randn(g, k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        got = pack_operand(w, default_blocks(k, n), dtype="int4")
        if not _same_pack(torch, (got.payload, got.scales),
                          pack_reference(w, got.layout)):
            raise AssertionError(f"K6 granite expert stack {i} int4: payload "
                                 "or scales differ from the plain version")
    torch.cuda.synchronize()
    print(f"[k6-grouped] all {3 * layers} expert stacks of a full-width "
          f"granite packed into int4, byte-equal to the plain version "
          f"({time.perf_counter() - t0:.2f} s with the draws and checks)")
    rows = {}
    for fmt, acc in model.items():
        rows[fmt] = acc.row("float32")
        print(f"[k6-grouped] packing a full-width granite-moe ({acc.launches} "
              f"launches) into {fmt}: kernel {acc.ms:.3f} ms, scalar kernel "
              f"{acc.scalar_ms:.3f} ms, plain {acc.plain_ms:.3f} ms, bound "
              f"{acc.bound_ms:.3f} ms")
    return rows


# ----------------------------------------------------------------- phase 6b

SPARSE_BLOCKS = (128, 128)


def _sparse_weight(torch, gen, shape, dtype, method):
    """A tile-sparse operand built on the card from a random f32 weight;
    ``method`` is "magnitude" (50 %), "nm" (2:4) or a keep-mask."""
    from repro_torch.sparse import sparsify_magnitude, sparsify_nm, \
        sparsify_with_mask

    k, n = shape[-2:]
    w = torch.randn(*shape, generator=gen, device="cuda") * \
        (2.0 / (k + n)) ** 0.5
    if not isinstance(method, str):
        return sparsify_with_mask(w, SPARSE_BLOCKS, method, dtype=dtype)
    if method == "nm":
        return sparsify_nm(w, SPARSE_BLOCKS, n_keep=2, m_block=4, dtype=dtype)
    return sparsify_magnitude(w, SPARSE_BLOCKS, density=0.5, dtype=dtype)


def phase_k3(torch, timer):
    """K3 against its plain version: phi3-mini's GEMMs at 50 % magnitude
    (bf16 A x bf16 tiles, and int8 A x int8 tiles with the activation
    scale), granite's attention projections and expert stacks (grouped)
    under int8 N:M 2:4, an empty column and a K tail; every case on the
    design ``kernels/mpgemm.py::k3_design`` names (all of them its wgmma
    design, ``kernels/csrc/mpgemm_sparse_wgmma.cu`` / ``_int8.cu``), the
    same bits from two launches, and each weight's largest and mean
    stored tiles a column printed beside its time (a magnitude pattern is
    skewed, N:M is not).  Times per launch on a cold L2; bound from the
    stored-tile, A and output bytes or the stored tiles' operations; the
    library time is ``torch.matmul`` on the weight densified beforehand,
    plus the epilogue."""
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import (
        mpgemm_sparse, mpgemm_sparse_grouped, mpgemm_sparse_plain,
    )
    from repro_torch.sparse import densify_operand

    k3_design = _rule("k3_design")
    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    g = GRANITE_EXPERTS
    # (step row, name, weight shape, kind, act, policy, pattern, per step)
    cases = [("phi3-bf16", name, (k, n), kind, act, "bf16", "magnitude",
              per_step) for name, k, n, kind, act, per_step in MAIN_SHAPES]
    cases += [("phi3-int8", name, (k, n), kind, act, "int8", "magnitude",
               per_step) for name, k, n, kind, act, per_step in MAIN_SHAPES]
    cases += [("granite-int8", f"g-{name}", (k, n), "linear", None, "int8",
               "nm", per_step)
              for name, k, n, _, _, per_step in GRANITE_2D_SHAPES
              if name in ("wq/wo", "wk/wv")]
    cases += [("granite-grouped-int8", f"e-{name}", (g, k, n), kind, act,
               "int8", "nm", per_step)
              for name, k, n, kind, act, per_step in GROUPED_SHAPES]
    # Edge cases: column tile 1 empty and a K tail (K = 3000 over 128).
    keep = np.random.default_rng(0).random((24, 24)) < 0.5
    keep[:, 1] = False
    keep[-1, :] = True
    cases += [(None, "edge", (3000, 3072), "residual", "gelu", pol, keep, 0)
              for pol in ("bf16", "int8")]
    steps = {row: StepSum() for row, *_ in cases if row}
    for row, name, shape, kind, act, policy, method, per_step in cases:
        grouped = len(shape) == 3
        dtype = "int8" if policy == "int8" else "bfloat16"
        b = _sparse_weight(torch, gen, shape, dtype, method)
        lay = b.layout
        cols = (f"cols max {lay.max_column_tiles} mean "
                f"{lay.nnz / (len(lay.indptr) - 1):.2f}")
        out_dtype = f32 if grouped else bf16
        w_lib = densify_operand(b, dtype=bf16)
        k, n = shape[-2:]
        ep = EpilogueSpec(kind=kind, activation=act)
        wrapper = mpgemm_sparse_grouped if grouped else mpgemm_sparse
        for m in (2, 32):
            lead = (g, m) if grouped else (m,)
            x = torch.randn(*lead, k, generator=gen, device="cuda").to(bf16)
            xq, sx = quantize_per_tensor(x)
            a, scale = (xq, sx) if policy == "int8" else (x, None)
            extras = () if kind == "linear" else (
                torch.randn(*lead, n, generator=gen,
                            device="cuda").to(out_dtype),)
            kw = dict(scale=scale, extras=extras, epilogue=ep,
                      out_dtype=out_dtype)

            def kern():
                return wrapper(a, b, **kw)

            def plain():
                return mpgemm_sparse_plain(a, b, **kw)

            def library():
                acc = torch.matmul(x, w_lib)
                return apply_epilogue(ep, acc.float(),
                                      extras=extras).to(out_dtype)

            (got, design), again, ref = _k3_design_of(kern), kern(), plain()
            torch.cuda.synchronize()
            err = _check_close(torch, f"K3 {name} m={m} {policy}", got, ref,
                               TOL[_dtype_name(out_dtype)])
            if not torch.equal(got, again):
                raise AssertionError(f"K3 {name} m={m}: two launches differ")
            if k3_design and design != k3_design(a, b):
                raise AssertionError(f"K3 {name} m={m}: ran {design}, the "
                                     f"rule says {k3_design(a, b)}")
            del again
            esz = a.element_size()
            tile_bytes = lay.nnz * lay.bk * lay.bn * esz
            scale_bytes = 4 * lay.nnz if lay.per_tile_scales else 0
            out_bytes = got.numel() * got.element_size()
            n_bytes = (tile_bytes + scale_bytes + a.numel() * esz
                       + out_bytes * (1 + len(extras)))
            n_ops = 2 * m * lay.nnz * lay.bk * lay.bn
            peak = "int8" if policy == "int8" else "bfloat16"
            bound, bound_by = _bound_ms(n_bytes, n_ops, peak)
            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
            print(f"[k3] {name:>8} {'x'.join(map(str, shape)):>14} m={m:<3} "
                  f"{policy:>4} {design:>5} d={lay.density:.3f} {cols}: err "
                  f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f}  "
                  f"library {lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s")
            if row:
                steps[row].max_abs_err = max(steps[row].max_abs_err, err)
                steps[row].designs.append(design)
                if m == 2:
                    steps[row].add(per_step, ms, plain_ms, lib_ms, bound,
                                   n_bytes, n_ops)
        del b, w_lib
    rows = {}
    for row, st in steps.items():
        r = rows[row] = st.row("int8" if "int8" in row else "bfloat16")
        r["designs"] = st.designs
        print(f"[k3] one full-width decode step, {row} (M=2, {st.launches} "
              f"launches): kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms "
              f"(densified beforehand), bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
    return rows


# ------------------------------------------------------------------ phase 7

def _counters():
    """The counted kernel wrappers by kernel (``k1`` ... ``k7``)."""
    from repro_torch.kernels.counters import wrappers
    return wrappers()


def _reset_counters():
    """Every launch count to 0 (the per-variant and per-design counts
    too)."""
    from repro_torch.kernels.counters import reset_launch_counts
    reset_launch_counts()


def _read_counters():
    """Every launch count (``repro_torch.kernels.counters``): ``k1`` ...
    ``k7``, K1's and grouped K1's ``trans_a`` and ``trans_b`` ones as
    ``k1_ta`` / ``k1_tb`` / ``k1g_ta`` / ``k1g_tb``, K2's and K3's
    ``trans_a`` ones as ``k2_ta`` / ``k2g_ta`` / ``k3_ta`` / ``k3g_ta``,
    those that ran the wgmma design of K1, K2 and K3 as ``k1_wgmma`` ...
    ``k3g_wgmma``, K1's f32 ones on the tensor cores as ``k1_tf32x3`` /
    ``k1g_tf32x3``, K4's and K5's on their wgmma and split designs as
    ``k4_wgmma`` / ``k4_split`` / ``k5_wgmma`` / ``k5_split``, and K4's f32
    ones on its tf32x3 design as ``k4_tf32x3``."""
    from repro_torch.kernels.counters import launch_counts
    return launch_counts()


def _k4_design_of(call):
    """Run ``call`` (one K4 launch) -> (its output, the design that ran it:
    "wgmma", "split", "tf32x3" or "simt", read off the counters)."""
    return _design_of(call, ("k4",), ("wgmma", "split", "tf32x3"))


def _k5_design_of(call):
    """Run ``call`` (one K5 launch) -> (its output, the design that ran it:
    "wgmma", "split" or "simt", read off the counters)."""
    fn = _counters()["k5"]

    def count(design):
        return getattr(fn, f"{design}_launches", 0)

    before = (count("wgmma"), count("split"))
    out = call()
    return out, ("wgmma" if count("wgmma") > before[0] else
                 "split" if count("split") > before[1] else "simt")


def _design_of(call, kernels, designs=("wgmma",)):
    """Run ``call`` (one launch of K1, K2 or K3, 2-D or grouped: the
    counters ``kernels``) -> (its output, the design that ran it: one of
    ``designs`` or "simt", read off the counters; 0 on a tree without the
    design, for chip_ab.py)."""
    c = _counters()

    def count(design):
        return sum(getattr(c[k], f"{design}_launches", 0) for k in kernels)

    before = [count(d) for d in designs]
    out = call()
    return out, next((d for d, n in zip(designs, before) if count(d) > n),
                     "simt")


def _k2_design_of(call):
    """Run ``call`` (one K2 launch) -> (its output, "wgmma" or "simt")."""
    return _design_of(call, ("k2", "k2g"))


def _k3_design_of(call):
    """Run ``call`` (one K3 launch) -> (its output, "wgmma" or "simt")."""
    return _design_of(call, ("k3", "k3g"))


def _rule(name):
    """The design rule ``name`` of ``kernels/mpgemm.py``, or None on a
    tree without it (chip_ab.py runs these phases on older trees)."""
    from repro_torch.kernels import mpgemm
    return getattr(mpgemm, name, None)


def _check_k4_designs(label, counts, simt=0):
    """Every K4 launch of a path ran a Hopper design (``k4_design``): its
    operands are bf16 or f32 with head widths the rule takes (f32: more
    than 16 folded rows a kv head) -- but ``simt`` of them, which must run
    the first scalar kernel (head widths above ``K4_MAX_D``)."""
    tf32x3 = counts.get("k4_tf32x3", 0)
    new = counts["k4_wgmma"] + counts["k4_split"] + tf32x3
    print(f"[{label}] K4 designs: wgmma {counts['k4_wgmma']}, split "
          f"{counts['k4_split']}, tf32x3 {tf32x3}, scalar "
          f"{counts['k4'] - new} of {counts['k4']} launches")
    if counts["k4"] - new != simt:
        raise AssertionError(f"{label}: {counts['k4'] - new} K4 launches "
                             f"ran the scalar kernel, want {simt}")


def _k4_max_d():
    """The widest head K4's Hopper designs take."""
    from repro_torch.kernels.flash_attention import K4_MAX_D
    return K4_MAX_D


def _k1_design_of(call):
    """Run ``call`` (one K1 launch) -> (its output, "wgmma", "tf32x3",
    "fma" or "simt")."""
    return _design_of(call, ("k1", "k1g"), ("wgmma", "tf32x3", "fma"))


def _k1_scalar(torch, a, b, *, trans_a=False, trans_b=False, bias=None,
               extras=(), c=None, epilogue=None, out_dtype=None):
    """K1's scalar loop (``csrc/mpgemm.cu``) on these operands, launched
    through its library (``_lib().mpgemm_launch``) whatever ``k1_design``
    says: the oracle the fma design is held to bit for bit.  Counts no
    launch."""
    from repro_torch.core.gemm_spec import LINEAR
    from repro_torch.kernels import _build
    from repro_torch.kernels import mpgemm as mk

    epilogue = epilogue or LINEAR
    g = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:][::-1] if trans_a else a.shape[-2:]
    n = b.shape[-2] if trans_b else b.shape[-1]
    out = torch.empty(*a.shape[:-2], m, n, dtype=out_dtype or a.dtype,
                      device=a.device)
    kept, (bi, ex, cp, rs, sc, out_dt, c_dt, bias_stride, kind, act, alpha,
           beta) = mk._epilogue_args(a, out, c, bias, None, tuple(extras),
                                     epilogue, False)
    lib = mk._lib()
    rc = lib.mpgemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc, g, m,
        n, k, bias_stride, mk._DTYPE_CODES[a.dtype], out_dt, c_dt,
        int(trans_a), int(trans_b), kind, act, alpha, beta,
        _build.current_stream(a))
    if rc != 0:
        raise RuntimeError(f"scalar K1 launch failed: CUDA error {rc} "
                           f"({lib.mpgemm_error_string(rc).decode()})")
    del kept
    return out


def _check_fma_bits(torch, label, got, again, scalar):
    """The fma design's output ``got`` against a second launch's
    (``again``) and the scalar loop's (``scalar``), bit for bit; -> the
    scalar loop's max |diff| (0.0)."""
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches of the fma design "
                             f"differ")
    if not torch.equal(got, scalar):
        diff = (got.float() - scalar.float()).abs().max().item()
        raise AssertionError(f"{label}: the fma design is not bit-equal to "
                             f"the scalar loop (max |diff| {diff:.3e})")
    return 0.0


def _check_wgmma(label, got, want):
    """Every bf16 and int8 K1 launch of a path ran the wgmma design, every
    K2 and K3 launch (2-D and grouped) its wgmma design, and every K5
    launch one of K5's Hopper designs (split or wgmma): ``got`` and
    ``want`` map ``k1`` / ``k1g`` / ``k2`` / ``k2g`` / ``k3`` / ``k3g`` /
    ``k5`` to the launches on those designs and to the launches that must
    be."""
    print(f"[{label}] Hopper designs: K1 wgmma {got['k1']} of {want['k1']} "
          f"bf16 / int8 launches, grouped K1 {got['k1g']} of {want['k1g']}; "
          f"K2 wgmma {got['k2']} of {want['k2']}, grouped K2 {got['k2g']} "
          f"of {want['k2g']}; K3 wgmma {got['k3']} of {want['k3']}, "
          f"grouped K3 {got['k3g']} of {want['k3g']}; K5 split + wgmma "
          f"{got['k5']} of {want['k5']}")
    if got != want:
        raise AssertionError(f"{label}: Hopper-design launches {got}, want "
                             f"{want}")


def _want_launches(cfg, pack, n_steps, sparse=False):
    """Every launch count of a serve run: per ``paged_step`` each layer has
    4 attention projections, then 3 dense MLP GEMMs (2 for a GELU MLP) or
    (MoE) 1 f32 router GEMM and 3 grouped expert GEMMs, plus the head.
    Packing (K2) or sparsifying (K3) covers every projection, MLP weight
    and expert stack and an untied head, never the router or a tied head
    (the embedding), and takes one K6 pack launch per weight at load."""
    n_layers, moe = cfg.n_layers, cfg.family == "moe"
    dense_2d = 1 if moe else _mlp_mats(cfg)   # router | [gate,] up, down
    grouped = 3 if moe else 0             # expert gate, up, down
    head_done = (pack or sparse) and not cfg.tie_embeddings
    per_step = dict(k1=0, k1g=0, k2=0, k2g=0, k3=0, k3g=0)
    if pack or sparse:
        fmt = "k2" if pack else "k3"
        per_step.update({
            "k1": n_layers * (1 if moe else 0) + (0 if head_done else 1),
            fmt: n_layers * (4 if moe else 4 + dense_2d) + int(head_done),
            fmt + "g": n_layers * grouped})
    else:
        per_step.update(k1=n_layers * (4 + dense_2d) + 1,
                        k1g=n_layers * grouped)
    want = {k: v * n_steps for k, v in per_step.items()}
    want["k4"] = want["k7"] = 0
    want["k5"] = n_layers * n_steps
    want["k6"] = (n_layers * (4 + (3 if moe else dense_2d)) + int(head_done)
                  if pack or sparse else 0)
    return want, per_step


def _mlp_mats(cfg):
    """GEMMs of a dense MLP: up and down, and the gate of a SwiGLU."""
    return 2 if cfg.mlp == "gelu" else 3


def phase_serve(torch, *, label, arch="phi3-mini-3.8b", policy="bf16",
                pack=False, pack_format=None, n_layers=None, sparsity=0.0,
                sparsity_method="magnitude", fused=True):
    """Serve 4 requests through the engine; every launch count of the run
    (packing or sparsifying at load included) must be what the path
    needs.  ``fused=False`` serves the unfused MLPs (``--no-fuse``): the
    same launch counts, and one mixed step's logits also against the
    fused model's."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.packing.params import packed_param_bytes
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sparse import sparse_param_bytes, sparse_param_density

    cfg = cb.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_layers = cfg.n_layers
    model = build_model(cfg, policy=policy, device="cuda",
                        fused_epilogues=fused)
    counters = _counters()
    _reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        pack=pack, pack_format=pack_format, sparsity=sparsity,
                        sparsity_method=sparsity_method)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dense = sum(t.numel() * t.element_size() for t in _leaves(params)
                if isinstance(t, torch.Tensor))
    payload = packed_param_bytes(params) + sparse_param_bytes(params)
    how = ""
    if pack:
        how = f", packed {pack_format or 'at the policy dtype'}"
    elif sparsity:
        density = sparse_param_density(params, model.cfg)
        how = (f", tile-sparse {sparsity_method} at sparsity {sparsity} "
               f"(tile density {density:.4f}, "
               f"{SPARSE_BLOCKS[0]} x {SPARSE_BLOCKS[1]} tiles)")
    kind = "sparse" if sparsity else "packed"
    peak = torch.cuda.max_memory_allocated() / 1e9
    how += "" if fused else ", unfused MLPs (--no-fuse)"
    print(f"[serve:{label}] {cfg.name}, {n_layers} layers, policy {policy}"
          f"{how}: {payload / 1e9:.3f} GB {kind} payload + "
          f"{dense / 1e9:.3f} GB dense tensors, initialised on the card in "
          f"{t_init:.3f} s ({peak:.2f} GB allocated at the peak)")

    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, (int(rng.integers(4, 33)),))
               .astype(np.int32) for _ in range(4)]

    def serve_once(cuda_graphs):
        """The four requests through a fresh engine -> (tokens, engine,
        wall s); every step's logits must be finite."""
        eng = ServeEngine(model, params, max_len=64, max_batch=2,
                          page_size=16, cuda_graphs=cuda_graphs)
        finite = _finite_samples(torch, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=16)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(finite) != len(eng.step_telemetry) or not all(finite):
            raise AssertionError(f"serve:{label}: non-finite logits during "
                                 f"serving ({finite})")
        return out, eng, wall

    out, eng, wall = serve_once(None)
    counts = {name: fn.launches for name, fn in counters.items()}
    wgmma = {name: counters[name].wgmma_launches
             for name in ("k1", "k1g", "k2", "k2g", "k3", "k3g")}
    wgmma["k5"] = (counters["k5"].wgmma_launches
                   + counters["k5"].split_launches)
    tf32x3 = counters["k1"].tf32x3_launches
    fma = getattr(counters["k1"], "fma_launches", None)
    k6_stream = getattr(counters["k6"], "stream_launches", None)
    k5_designs = {d: getattr(counters["k5"], f"{d}_launches")
                  for d in ("split", "wgmma")}
    n_steps = len(eng.step_telemetry)
    want, per_step = _want_launches(cfg, pack, n_steps, sparse=sparsity > 0)
    n_tok = sum(len(v) for v in out.values())
    tokens_sha1 = _sha1(*(np.asarray(out[uid]) for uid in sorted(out)))
    decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
    prefill = [s.wall_s for s in eng.step_telemetry if s.phase != "decode"]
    graphs = eng.graphs
    replays = sum(g.replays for g in graphs.values())
    decode_replays = graphs[1].replays if 1 in graphs else 0
    capture_s = sum(g.capture_s for g in graphs.values())
    pool_mb = eng.graph_pool_bytes() / 2**20
    print(f"[serve:{label}] 4 requests (prompts "
          f"{[len(p) for p in prompts]}), {n_tok} tokens in {wall:.3f} s "
          f"= {n_tok / wall:.2f} tok/s; {n_steps} steps ({len(prefill)} "
          f"with prefill, median {1e3 * np.median(prefill):.2f} ms); median "
          f"decode step {1e3 * np.median(decode):.2f} ms; tokens sha1 "
          f"{tokens_sha1}")
    print(f"[serve:{label}] CUDA graphs: {len(graphs)} captured (chunk "
          f"widths {sorted(graphs)}), {replays} replays ({decode_replays} of "
          f"width 1), {capture_s:.3f} s "
          f"capturing in all, pool {pool_mb:.2f} MB")
    if not decode_replays:
        raise AssertionError(f"serve:{label}: no replay of the decode "
                             f"graph (width 1)")
    if len(graphs) + replays != n_steps:
        raise AssertionError(f"serve:{label}: {len(graphs)} captures + "
                             f"{replays} replays for {n_steps} steps")
    print(f"[serve:{label}] launches: K1 {counts['k1']}, grouped K1 "
          f"{counts['k1g']}, K2 {counts['k2']}, grouped K2 {counts['k2g']}, "
          f"K3 {counts['k3']}, grouped K3 {counts['k3g']}, "
          f"K5 {counts['k5']} ({n_steps} steps x {per_step} and "
          f"{n_layers} attention layers), K6 {counts['k6']} at load "
          f"({k6_stream} on the stream design)")
    # eos (id 1) may end a request early; every request must finish.
    if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
        raise AssertionError(f"served {sorted(out)} of 4 requests")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    # bf16 and int8 K1 launches: all of them but the MoE routers (f32),
    # under either policy (every width of both models is a multiple of 16);
    # every K2 launch (bf16 A x int4, int8 A x int8 payloads in 128 x 128
    # tiles), every K3 launch (bf16 A x bf16, int8 A x int8 tiles of 128 x
    # 128) and every K5 launch (bf16 pools of pages of 16).
    routers = n_layers if cfg.family == "moe" else 0
    _check_wgmma(f"serve:{label}", wgmma, dict(
        k1=(per_step["k1"] - routers) * n_steps,
        k1g=per_step["k1g"] * n_steps, k2=counts["k2"], k2g=counts["k2g"],
        k3=counts["k3"], k3g=counts["k3g"], k5=counts["k5"]))
    print(f"[serve:{label}] K5 designs: split {k5_designs['split']}, wgmma "
          f"{k5_designs['wgmma']}; K1 tf32x3 {tf32x3}, fma {fma} (the f32 "
          f"routers)")
    if tf32x3:
        raise AssertionError(f"serve:{label}: {tf32x3} K1 launches on "
                             f"tf32x3; the f32 routers keep the fp32 "
                             f"policy's f32 FMA")
    if k6_stream is not None and k6_stream != counts["k6"]:
        raise AssertionError(f"serve:{label}: {counts['k6'] - k6_stream} of "
                             f"the load's {counts['k6']} K6 launches ran "
                             f"the scalar kernel, want none")
    if fma is not None and fma != routers * n_steps:
        raise AssertionError(f"serve:{label}: {fma} K1 launches on the fma "
                             f"design, want every router's "
                             f"({routers * n_steps})")
    serve = dict(tokens=n_tok, tokens_sha1=tokens_sha1, wall_s=wall,
                 tok_per_s=n_tok / wall, steps=n_steps,
                 payload_gb=payload / 1e9,
                 decode_step_ms=1e3 * float(np.median(decode)),
                 ttft_ms=1e3 * float(np.median(prefill)), **counts,
                 k2_wgmma=wgmma["k2"], k2g_wgmma=wgmma["k2g"],
                 k3_wgmma=wgmma["k3"], k3g_wgmma=wgmma["k3g"],
                 k1_fma=fma, k6_stream=k6_stream, k5_designs=k5_designs,
                 graphs=len(graphs),
                 replays=replays, capture_s=capture_s, pool_mb=pool_mb)
    del eng, graphs
    # The same requests on the eager step: the same tokens, and the
    # wrappers' own counts (no K6: the weights are loaded).
    _reset_counters()
    out_eager, eager, wall_eager = serve_once(False)
    counts = {name: fn.launches for name, fn in counters.items()}
    want, _ = _want_launches(cfg, pack, len(eager.step_telemetry),
                             sparse=sparsity > 0)
    want["k6"] = 0
    decode = [s.wall_s for s in eager.step_telemetry if s.phase == "decode"]
    prefill = [s.wall_s for s in eager.step_telemetry
               if s.phase != "decode"]
    serve.update(eager_tok_per_s=n_tok / wall_eager,
                 eager_decode_step_ms=1e3 * float(np.median(decode)),
                 eager_ttft_ms=1e3 * float(np.median(prefill)))
    print(f"[serve:{label}] eager step (cuda_graphs=False): "
          f"{n_tok / wall_eager:.2f} tok/s, median decode step "
          f"{serve['eager_decode_step_ms']:.2f} ms, first-token steps "
          f"{serve['eager_ttft_ms']:.2f} ms; tokens "
          f"{'identical to' if out_eager == out else 'DIFFER from'} the "
          f"captured run's")
    if out_eager != out:
        raise AssertionError(f"serve:{label}: eager tokens {out_eager}, "
                             f"captured {out}")
    if counts != want:
        raise AssertionError(f"serve:{label}: eager launch counts {counts}, "
                             f"want {want}")
    serve["logit_err"] = _kernel_vs_plain_step(torch, model, params, label)
    if not fused:
        serve["fused_logit_err"] = _kernel_vs_plain_step(
            torch, model, params, label,
            against=dataclasses.replace(model, fused_epilogues=True))
    args = _decode_args(torch, model)

    def step():
        return model.paged_step(params, *args)[0]

    replay = _captured_step(torch, model, params, args)
    eager_logits, replayed = step().clone(), replay().clone()
    torch.cuda.synchronize()
    if not torch.equal(eager_logits, replayed):
        diff = (eager_logits.float() - replayed.float()).abs().max().item()
        raise AssertionError(f"serve:{label}: a replayed decode step's "
                             f"logits differ from the eager step's by {diff}")
    print(f"[serve:{label}] one replayed two-row decode step: logits "
          f"bit-equal to the eager step's")
    for key, what, fn, tag in (("", "eager", step, label),
                               ("graph_", "replayed", replay,
                                f"{label}+graph")):
        enqueue, done = _decode_step_times(torch, fn)
        print(f"[serve:{label}] one {what} two-row decode step: the host "
              f"enqueues it in {enqueue:.2f} ms, the device is done after "
              f"{done:.2f} ms")
        busy, idle = _profile_decode_step(
            torch, fn, tag, done, what=f"one {what} two-row decode step")
        serve.update({f"{key}enqueue_ms": enqueue, f"{key}step_ms": done,
                      f"{key}busy_ms": busy, f"{key}idle": idle})
    return serve


def _finite_samples(torch, eng):
    """Check every step's logits for finite values where the engine samples
    them, after the step (after a replay; never inside a capture) -> the
    list of each step's result."""
    finite, sample = [], eng._sample

    def checked(logits):
        finite.append(bool(torch.isfinite(logits.float()).all()))
        return sample(logits)

    eng._sample = checked
    return finite


def _captured_step(torch, model, params, args):
    """``model.paged_step(params, *args)`` (``_decode_args``' inputs)
    captured as the engine captures it: one eager warm-up on a stream of
    its own, then :class:`StepGraph` -> a function that replays it on that
    stream, ordered after the current stream's work and before its next,
    and returns the logits."""
    from repro_torch.serve.engine import StepGraph

    tokens, caches, bt, q_start, n_valid = args
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        model.paged_step(params, *args)
        graph = StepGraph(model, params, caches,
                          [tokens, bt, q_start, n_valid], stream=stream,
                          pool=torch.cuda.graph_pool_handle())
    return _replay_on(torch, stream, graph)


def _replay_on(torch, stream, graph):
    """-> a function that replays ``graph`` on ``stream``, ordered after
    the current stream's work and before its next, and returns the
    logits."""
    def replay():
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            logits = graph.replay()
        torch.cuda.current_stream().wait_stream(stream)
        return logits

    return replay


# The serve paths of phase 7, by label: phase_serve's arguments.  The
# packed and sparse paths run at half depth (16 of phi3's 32 layers, 12 of
# granite's 24) so that the training phases fit the script's time: each
# layer is the same, so the launch counts per layer and every kernel's
# shapes stay those of the full model.
SERVE_PATHS = {
    "bf16": dict(),
    "int4": dict(pack=True, pack_format="int4", n_layers=16),
    "int8": dict(policy="int8", pack=True, n_layers=16),
    "int8-dense": dict(policy="int8", n_layers=4),
    "phi3-sparse-bf16": dict(sparsity=0.5, n_layers=16),
    "granite-bf16": dict(arch="granite-moe-1b-a400m"),
    "granite-int4": dict(arch="granite-moe-1b-a400m", pack=True,
                         pack_format="int4", n_layers=12),
    "granite-int8": dict(arch="granite-moe-1b-a400m", policy="int8",
                         pack=True, n_layers=12),
    "granite-int8-dense": dict(arch="granite-moe-1b-a400m", policy="int8",
                               n_layers=4),
    "granite-sparse-int8": dict(arch="granite-moe-1b-a400m", policy="int8",
                                sparsity=0.5, sparsity_method="nm",
                                n_layers=12),
    # The dense and MoE architectures the port serves besides phi3-mini and
    # granite, bf16 at full width: starcoder2-3b (30 layers, ~6.4 GB) and
    # phi3-medium-14b (40 layers, ~29 GB) at full depth, mixtral-8x22b at
    # MIXTRAL_LAYERS of its 56 (a layer holds ~4.9 GB of bf16 weights, so
    # all 56 would need ~280 GB: the card holds 80).
    "starcoder2-bf16": dict(arch="starcoder2-3b"),
    "phi3-medium-bf16": dict(arch="phi3-medium-14b"),
    "mixtral-bf16": dict(arch="mixtral-8x22b", n_layers=MIXTRAL_LAYERS),
}
# --no-fuse (the unfused MLPs), served right after the op-level phase: cut
# to 8 of phi3's 32 layers and 6 of granite's 24 to keep the script's time
# (every layer is the same, so the counts per layer and the shapes stay).
NO_FUSE_PATHS = {
    "phi3-no-fuse": dict(fused=False, n_layers=8),
    "granite-no-fuse": dict(arch="granite-moe-1b-a400m", fused=False,
                            n_layers=6),
}


def _leaves(tree):
    return (leaf for _, leaf in _tree_paths(tree))


def _exact_operand(b, a_dtype):
    """The f64 weight a packed or tile-sparse ``b`` holds, (k, n) or (g, k,
    n), as its plain version reads it against A of ``a_dtype``: each tile
    decoded and times its scale -- then rounded to A's dtype for float A,
    as the plain version rounds it --, zeros at a sparse operand's pruned
    tiles."""
    import torch

    from repro_torch.packing.layout import PackedOperand
    from repro_torch.packing.pack import decode_payload_tiles

    lay = b.layout
    g, nkb, nnb, bk, bn = lay.g, lay.nkb, lay.nnb, lay.bk, lay.bn
    scales = b.scales
    if isinstance(b, PackedOperand):
        tiles = decode_payload_tiles(
            b.payload.reshape(g, nkb, nnb, *lay.payload_tile), lay)
        if scales is not None:
            scales = scales.reshape(g, nkb, nnb)
    else:
        counts = (b.indptr[1:] - b.indptr[:-1]).long()
        col = torch.repeat_interleave(
            torch.arange(g * nnb, device=b.payload.device), counts,
            output_size=lay.nnz)
        at = (col // nnb, b.indices.long(), col % nnb)
        tiles = torch.zeros(g, nkb, nnb, bk, bn, dtype=b.payload.dtype,
                            device=b.payload.device)
        tiles[at] = b.payload[:lay.nnz]
        if scales is not None:
            full = torch.zeros(g, nkb, nnb, device=b.payload.device)
            full[at] = scales[:lay.nnz].float().reshape(-1)
            scales = full
    if scales is None:
        w = tiles.double()
    elif a_dtype == torch.int8:
        w = tiles.double() * scales.double()[..., None, None]
    else:
        w = (tiles.float() * scales[..., None, None]).to(a_dtype).double()
    w = w.permute(0, 1, 3, 2, 4).reshape(g, nkb * bk, nnb * bn)
    w = w[:, :lay.k, :lay.n]
    return w if g > 1 else w[0]


def _exact_gemm(a, b, *, spec, out_dtype=None, c=None, f32_fma=False,
                **kw):
    """A GEMM of ``core/gemm.py`` with its sum in f64 (then the plain
    epilogue in f32 and the output cast): the plain version's function
    without its f32 rounding, the yardstick of how far a model's logits
    move with the order of an f32 sum.  A packed or tile-sparse ``b`` is
    decoded first (``_exact_operand``)."""
    from repro_torch.kernels import mpgemm as mk
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse import TileSparseOperand

    aw = a.double()
    if isinstance(b, (PackedOperand, TileSparseOperand)):
        bw, trans_b = _exact_operand(b, a.dtype), False
    else:
        bw, trans_b = b.double(), spec.trans_b
    acc = ((aw.transpose(-1, -2) if spec.trans_a else aw)
           @ (bw.transpose(-1, -2) if trans_b else bw)).float()
    return mk._epilogue_plain(kw.get("epilogue", mk.LINEAR), acc,
                              kw.get("bias"), kw.get("scale"), c,
                              kw.get("extras", ()),
                              out_dtype or spec.out_dtype or a.dtype)


def _plain_gemm(a, b, *, spec, out_dtype=None, c=None, f32_fma=False,
                **kw):
    """The plain version of a call ``core/gemm.py`` makes to its GEMM
    wrappers (``mpgemm`` or ``mpgemm_grouped``), by the form of ``b``
    (f32 FMA arithmetic whatever ``f32_fma`` asks)."""
    from repro_torch.kernels.mpgemm import (
        mpgemm_packed_plain, mpgemm_plain, mpgemm_sparse_plain,
    )
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse import TileSparseOperand

    out_dtype = out_dtype or spec.out_dtype
    if isinstance(b, PackedOperand):
        return mpgemm_packed_plain(a, b, out_dtype=out_dtype,
                                   trans_a=spec.trans_a, **kw)
    if isinstance(b, TileSparseOperand):
        return mpgemm_sparse_plain(a, b, out_dtype=out_dtype,
                                   trans_a=spec.trans_a, **kw)
    return mpgemm_plain(a, b, trans_a=spec.trans_a, trans_b=spec.trans_b,
                        out_dtype=out_dtype, **kw)


@contextlib.contextmanager
def _plain_versions(enabled=True, exact=False):
    """Within the block, every GEMM, attention, unpack (K7) and pack (K6)
    wrapper the model and its backward call is its plain version (the
    plain versions are rank-generic: they stand in for the 2-D and the
    grouped GEMM wrappers alike, ``trans_a`` and ``trans_b`` included);
    ``exact`` sums the dense GEMMs in f64 (``_exact_gemm``)."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, paged_flash_attention_plain,
    )
    from repro_torch.models import attention as attn_mod
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.packing.pack import (
        _layout_for, pack_reference, unpack_reference,
    )

    if not enabled:
        yield
        return

    def plain_unpack(p, *, dtype=None):            # K7's plain version
        layout = p.layout
        if dtype is None:
            dtype = layout.orig_dtype if layout.per_tile_scales \
                else layout.dtype
        return unpack_reference(p.payload, p.scales, layout, dtype)

    def plain_pack(w, blocks, *, trans_w=False, dtype=None):  # K6's
        layout = _layout_for(w, *blocks, trans_w=trans_w, dtype=dtype)
        return PackedOperand(*pack_reference(w, layout), layout)

    names = ("mpgemm", "mpgemm_grouped", "unpack_operand", "pack_operand")
    saved = ([getattr(gemm_mod, n) for n in names],
             attn_mod.paged_flash_attention, attn_mod.flash_attention)
    gemm = _exact_gemm if exact else _plain_gemm
    for n, fn in zip(names, (gemm, gemm, plain_unpack, plain_pack)):
        setattr(gemm_mod, n, fn)
    attn_mod.paged_flash_attention = paged_flash_attention_plain
    attn_mod.flash_attention = flash_attention_plain
    try:
        yield
    finally:
        for n, fn in zip(names, saved[0]):
            setattr(gemm_mod, n, fn)
        attn_mod.paged_flash_attention, attn_mod.flash_attention = saved[1:]


def _kernel_vs_plain_step(torch, model, params, label, against=None):
    """One full-width mixed step (a 16-token prefill chunk beside a decode
    row) through the kernels and through the plain versions -- or through
    the model ``against`` (the fused one, for an unfused ``model``) -- on
    copies of the same pools."""
    dev = "cuda"
    ps, w = 16, 4
    caches = model.init_paged_caches(1 + 2 * w, ps)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    vocab = model.cfg.vocab

    def toks(c):
        return torch.randint(2, vocab, (2, c), generator=gen, device=dev,
                             dtype=torch.int32)

    i32 = dict(dtype=torch.int32, device=dev)
    # Context: 16 tokens for row 0, 9 for row 1, through the kernels.
    model.paged_step(params, toks(16), caches, bt,
                     torch.tensor([0, 0], **i32),
                     torch.tensor([16, 9], **i32))
    step_in = (toks(16), bt, torch.tensor([16, 9], **i32),
               torch.tensor([16, 1], **i32))
    pools_k = [{k: v.clone() for k, v in c.items()} for c in caches]
    pools_p = [{k: v.clone() for k, v in c.items()} for c in caches]
    tokens, bt, qs, nv = step_in
    lk, _ = model.paged_step(params, tokens, pools_k, bt, qs, nv)

    with _plain_versions(enabled=against is None):
        lp, _ = (against or model).paged_step(params, tokens, pools_p, bt,
                                              qs, nv)
    lk, lp = lk.float()[:, :vocab], lp.float()[:, :vocab]
    diff = (lk - lp).abs()
    err, scale = diff.max().item(), lp.abs().max().item()
    top_agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    rel = LOGIT_REL_TOL["int8" if model.policy == "int8" else "bf16"]
    what = ("unfused vs fused" if against is not None
            else "kernels vs plain versions")
    print(f"[serve:{label}] one full-width mixed step, {what}: max |logit "
          f"diff| {err:.3e}, mean "
          f"{diff.mean().item():.3e} (bound {rel} x max |logit| = "
          f"{rel * scale:.3e}), argmax agreement {top_agree:.2f}; the "
          f"kernels' logits sha1 {_sha1(lk.cpu().numpy())}")
    if not (err <= rel * scale and torch.isfinite(lk).all()):
        raise AssertionError(f"{what}: the logits differ by {err:.3e}")
    return err


def _decode_args(torch, model):
    """The inputs of one two-row decode step (contexts of 40 and 20)."""
    ps, w = 16, 4
    caches = model.init_paged_caches(1 + 2 * w, ps)
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], **i32)
    tokens = torch.tensor([[5], [7]], **i32)
    return (tokens, caches, bt, torch.tensor([40, 20], **i32),
            torch.tensor([1, 1], **i32))


def _decode_step_times(torch, step, steps=5):
    """Median host time to enqueue one two-row decode step (``step()``),
    and the same step's time until the device is done.  Equal times alone
    do not say which side bounds the step (a full launch queue also blocks
    the host): :func:`_profile_decode_step` measures the device's busy
    time."""
    enqueue, total = [], []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(enqueue[1:])), \
        1e3 * float(np.median(total[1:]))


# Device kernels by name, as the profiler reports them (demangled).
TRACE_KERNELS = (("mpgemm_sparse", "K3"),
                 ("mpgemm_packed_wgmma_kernel", "K2 wgmma"),
                 ("mpgemm_packed_kernel", "K2"), ("mpgemm_int8_kernel", "K1"),
                 ("mpgemm_fma_kernel", "K1 fma"),
                 ("mpgemm_kernel", "K1"), ("mpgemm_wgmma_kernel", "K1 wgmma"),
                 ("paged_flash_kernel", "K5"),
                 ("paged_wgmma_kernel", "K5 wgmma"),
                 ("paged_split_kernel", "K5 split"),
                 ("flash_wgmma_kernel", "K4 wgmma"),
                 ("flash_split_kernel", "K4 split"),
                 ("flash_tf32x3_kernel", "K4 tf32x3"), ("flash_kernel", "K4"),
                 ("pack_kernel", "K6"))


def _profile_decode_step(torch, step, label, step_ms,
                         what="one two-row decode step", kinds_out=None):
    """One two-row decode step (``step()``; ``what`` names another step)
    under ``torch.profiler`` (``kinds_out``, a dict, receives the device's
    (count, ms) by kind): the
    device's busy time (the union of its kernels' and copies' spans)
    against the traced step's span (from the step's first host op to its
    last device op) and against ``step_ms``, the same step's time untraced
    (tracing slows the host, not the kernels); the device's ops by kind,
    and the host calls in the step that copy or wait.  -> (device busy ms,
    its idle share of the untraced step), or Nones when the profiler saw
    no device op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_step"):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    step = next(e for e in events if e.name == "traced_step"
                and e.device_type == DeviceType.CPU)
    t0, t_host = step.time_range.start, step.time_range.end
    # Kernels, copies and sets (the device was idle when tracing began, so
    # all are the step's); the trace also mirrors the "traced_step"
    # annotation on the device, which is no work of the device.
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "traced_step"),
                 key=lambda e: e.time_range.start)
    if not dev:
        print(f"[profile:{label}] the profiler saw no device activity: "
              f"device busy time not measured")
        return None, None
    # A replayed graph's first kernels start within microseconds of the
    # host's call, and the trace's device clock can read them earlier.
    t0 = min(t0, dev[0].time_range.start)
    busy, lo, hi = 0.0, None, None
    for e in dev:                      # union of the device spans
        s0, s1 = e.time_range.start, e.time_range.end
        if hi is None or s0 > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = s0, s1
        else:
            hi = max(hi, s1)
    busy += hi - lo
    span = max(hi, t_host) - t0
    kinds, names = {}, {}
    for e in dev:
        kind = next((k for key, k in TRACE_KERNELS if key in e.name),
                    "copy/set" if e.name.startswith(("Memcpy", "Memset"))
                    else "torch")
        n, ms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + 1, ms + (e.time_range.end - e.time_range.start)
                       / 1e3)
        n, ms = names.get(e.name, (0, 0.0))
        names[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start)
                         / 1e3)
    waits = {}
    for e in events:
        if (e.device_type == DeviceType.CPU and t0 <= e.time_range.start
                and e.time_range.end <= t_host
                and ("Synchronize" in e.name or "Memcpy" in e.name)):
            chain, p = [e.name], e.cpu_parent
            while p is not None and len(chain) < 6:
                chain.append(p.name)
                p = p.cpu_parent
            key = " < ".join(chain)
            waits[key] = waits.get(key, 0) + 1
    launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                   and "LaunchKernel" in e.name
                   and t0 <= e.time_range.start <= t_host)
    busy_ms, span_ms = busy / 1e3, span / 1e3
    print(f"[profile:{label}] {what} under torch.profiler: "
          f"{len(dev)} device ops ({launches} kernel-launch calls traced on "
          f"the host); device busy {busy_ms:.3f} ms of a {span_ms:.3f} ms "
          f"traced span (idle share {1 - busy_ms / span_ms:.3f}) and of the "
          f"{step_ms:.3f} ms untraced step (idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}); the host's last op ends "
          f"at {(t_host - t0) / 1e3:.3f} ms, the device's at "
          f"{(hi - t0) / 1e3:.3f} ms")
    print(f"[profile:{label}] device ops by kind (count, ms): " + ", ".join(
        f"{k} {n} {ms:.3f}" for k, (n, ms) in sorted(kinds.items())))
    if kinds_out is not None:
        kinds_out.update(kinds)
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[profile:{label}] the device's longest ops (count, ms): " +
          "; ".join(f"{name[:90]} {n} {ms:.3f}" for name, (n, ms) in top))
    print(f"[profile:{label}] host calls in the step that copy or wait "
          f"(with their callers): {waits or 'none'}")
    return busy_ms, max(0.0, 1 - busy_ms / step_ms)


# ----------------------------------------------------------------- phase 7b

# The wave path's GEMMs and K4 launches a layer by block kind, at a
# prefill and at a decode step, by what each GEMM's weight is: ``proj``
# a weight the reference packs and sparsifies (``QUANT_LEAVES``) used
# under the model's policy; ``gate`` such a weight under the fp32 policy
# (f32 operands: K1's fma design dense, K2's or K3's f32-A route packed or
# sparse); ``lora`` a weight it never packs, under the model's policy;
# ``router`` the MoE router (never packed, fp32 policy); ``experts`` the
# grouped expert stacks (packed and sparsified grouped); ``lora_b`` the
# RWKV LoRA's grouped f32 product (never packed, the fma design); ``k4``.
# m is the MLP's GEMMs (2 GELU, 3 SwiGLU).
#   dense / attn_local: 4 attention projections and the MLP, a causal K4
#     at prefill; a decode step's attention against the ring cache is
#     plain torch ops (as in the reference), so no K4.
#   moe: the 4 projections, the f32 router and 3 grouped expert GEMMs.
#   cross (VLM): q, k and v of the image states, o and the MLP, a
#     non-causal K4 over the image keys; at decode the K/V come from the
#     cache: q, o, the MLP and K4 at one query row.
#   encdec (whisper's decoder): self q, k, v, o, cross q, k, v, o and the
#     MLP, a causal and a cross K4; at decode 4 + 2 + m GEMMs and the
#     cross K4.
#   rwkv: wr, wk, wv, wg, wo, ck, cv, cr; lora_a and w_lora_a; the
#     grouped f32 LoRA (5 streams), no attention.
#   rglru: w_y, w_x, w_out and the SwiGLU MLP; the two f32 gates.
_WAVE_KEYS = ("proj", "gate", "lora", "router", "experts", "lora_b", "k4")
_WAVE_LAUNCHES = {
    "dense": lambda m: ((4 + m, 0, 0, 0, 0, 0, 1), (4 + m, 0, 0, 0, 0, 0, 0)),
    "moe": lambda m: ((4, 0, 0, 1, 3, 0, 1), (4, 0, 0, 1, 3, 0, 0)),
    "cross": lambda m: ((4 + m, 0, 0, 0, 0, 0, 1), (2 + m, 0, 0, 0, 0, 0, 1)),
    "encdec": lambda m: ((8 + m, 0, 0, 0, 0, 0, 2),
                         (6 + m, 0, 0, 0, 0, 0, 1)),
    "rwkv": lambda m: ((8, 0, 2, 0, 0, 1, 0),) * 2,
    "rglru": lambda m: ((3 + m, 2, 0, 0, 0, 0, 0),) * 2,
}
_WAVE_LAUNCHES["attn_local"] = _WAVE_LAUNCHES["dense"]


def _want_wave_launches(cfg, pack=False, sparse=False):
    """Launches per prefill and per decode step of the wave path, as dicts
    of ``k1``, ``k1_fma``, ``k1g``, ``k1g_fma`` and ``k4`` -- and, for a
    packed (``pack``) or tile-sparse (``sparse``) model, ``k2``, ``k2g``
    and ``k2_f32`` (of the K2 launches, those of f32 A: the gates) or the
    same of K3: each layer's by its kind (``_WAVE_LAUNCHES``), whisper's
    encoder layers (4 + 2 GEMMs and a non-causal K4 each, at prefill), and
    the head (packed or sparsified when untied).  The packed or sparse
    kernel takes every ``proj``, ``gate`` and ``experts`` GEMM; K1 the
    rest."""
    m = _mlp_mats(cfg)
    fmt = "k2" if pack else "k3" if sparse else None
    runs = []
    for step in (0, 1):
        n = dict.fromkeys(_WAVE_KEYS, 0)
        for kind in cfg.pattern:
            for key, c in zip(_WAVE_KEYS, _WAVE_LAUNCHES[kind](m)[step]):
                n[key] += c
        if step == 0:
            n["proj"] += cfg.encoder_layers * (4 + m)
            n["k4"] += cfg.encoder_layers
        head = 0 if fmt and not cfg.tie_embeddings else 1
        if fmt:
            n["proj"] += 1 - head
        want = dict(k1=n["lora"] + n["router"] + head,
                    k1_fma=n["router"], k1g=n["lora_b"],
                    k1g_fma=n["lora_b"], k4=n["k4"])
        if fmt:
            want.update({fmt: n["proj"] + n["gate"], f"{fmt}g": n["experts"],
                         f"{fmt}_f32": n["gate"]})
        else:
            want["k1"] += n["proj"] + n["gate"]
            want["k1_fma"] += n["gate"]
            want["k1g"] += n["experts"]
        runs.append(want)
    return tuple(runs)


def _wave_weights(cfg):
    """The GEMM weights the reference packs or sparsifies in ``cfg``: one
    K6 launch each at a packed or sparse load (a grouped expert stack is
    one).  A prefill reads each of them once, an untied head too."""
    prefill, _ = _want_wave_launches(cfg, pack=True)
    return prefill["k2"] + prefill["k2g"]


# The wave paths of phase 7, by label: phase_wave_serve's arguments, the
# architecture at full width and depth.  The first five are dense bf16;
# the cross and recurrent architectures serve only here (their caches are
# not paged, as in the reference), and each serves once more in one of
# the other forms: llama-vision under the int8 policy packed (int8
# payload), rwkv6 under the int8 policy dense (f32 weights quantized per
# call), recurrentgemma bf16 tile-sparse (magnitude, 50 %).
WAVE_PATHS = {
    "whisper": dict(arch="whisper-medium"),
    "phi3": dict(arch="phi3-mini-3.8b"),
    "llama-vision": dict(arch="llama-3.2-vision-11b"),
    "rwkv6": dict(arch="rwkv6-1.6b"),
    "recurrentgemma": dict(arch="recurrentgemma-2b"),
    "llama-vision-pack-int8": dict(arch="llama-3.2-vision-11b",
                                   policy="int8", pack=True),
    "rwkv6-int8": dict(arch="rwkv6-1.6b", policy="int8"),
    "recurrentgemma-sparse": dict(arch="recurrentgemma-2b", sparsity=0.5),
}


def phase_wave_serve(torch, *, label, arch, n_layers=None, policy="bf16",
                     pack=False, pack_format=None, sparsity=0.0,
                     sparsity_method="magnitude"):
    """Serve 4 requests through the wave engine (``ServeEngine(batch_size=
    2)``), captured (its default on the card) and again eagerly
    (``cuda_graphs=False``), after an untimed eager warm-up: the same
    tokens, and every launch count of each run what its prefills and
    decode steps need (a packed or sparse load's K6 launches too).  Then
    the kernels against the plain versions, and one replayed two-row
    decode step against the eager step, bit for bit, both timed and
    traced.  ``policy``, ``pack``, ``pack_format``, ``sparsity`` and
    ``sparsity_method`` are ``LM.init``'s, as the serve CLI passes
    them."""
    import dataclasses
    import warnings

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.packing.params import packed_param_bytes
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.sparse import sparse_param_bytes, sparse_param_density

    cfg = cb.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, policy=policy, device="cuda")
    cfg = model.cfg
    sparse = sparsity > 0
    counters = _counters()
    _reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        pack=pack, pack_format=pack_format, sparsity=sparsity,
                        sparsity_method=sparsity_method)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    load = _read_counters()
    dense = sum(t.numel() * t.element_size() for t in _leaves(params)
                if isinstance(t, torch.Tensor))
    payload = packed_param_bytes(params) + sparse_param_bytes(params)
    weights = dense + payload
    enc = (f" + {cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq} frames" if cfg.encoder_layers else "")
    how = "dense"
    if pack:
        how = f"packed {pack_format or 'at the policy dtype'}"
    elif sparse:
        how = (f"tile-sparse {sparsity_method} at sparsity {sparsity} (tile "
               f"density {sparse_param_density(params, cfg):.4f}, "
               f"{SPARSE_BLOCKS[0]} x {SPARSE_BLOCKS[1]} tiles)")
    print(f"[wave:{label}] {cfg.name}, {cfg.n_layers} decoder layers{enc}, "
          f"{how} {policy}: {weights / 1e9:.3f} GB of weights ("
          f"{payload / 1e9:.3f} GB {'sparse' if sparse else 'packed'} "
          f"payload + {dense / 1e9:.3f} GB dense tensors), initialised on "
          f"the card in {t_init:.3f} s "
          f"({torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated at "
          f"the peak)")
    # A packed or sparse load packs every weight the reference does, each
    # once, on K6's stream design; a dense load launches nothing.
    want_k6 = _wave_weights(cfg) if pack or sparse else 0
    print(f"[wave:{label}] load: K6 {load['k6']} launches ("
          f"{load['k6_stream']} on the stream design), want {want_k6}")
    busy = {k: n for k, n in load.items() if n and k not in ("k6",
                                                              "k6_stream")}
    if load["k6"] != want_k6 or load["k6_stream"] != want_k6 \
            or busy:
        raise AssertionError(f"wave:{label}: the load launched {load}, want "
                             f"{want_k6} K6 launches on the stream design "
                             f"and nothing else")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, (int(rng.integers(4, 33)),))
               .astype(np.int32) for _ in range(4)]
    per_prefill, per_decode = _want_wave_launches(cfg, pack=pack,
                                                  sparse=sparse)
    fmt = "k2" if pack else "k3" if sparse else None

    def serve_once(cuda_graphs):
        """The four requests through a fresh wave engine, the launch counts
        reset first -> a dict of the run: tokens, engine, wall s, counts,
        design counts, prefills and decode steps (from the telemetry: a
        replay bypasses ``model.decode_step``), the counts they need."""
        _reset_counters()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = ServeEngine(model, params, batch_size=2, max_len=64,
                              cuda_graphs=cuda_graphs)
        finite = _finite_samples(torch, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=16)
                            for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(finite) != len(eng.telemetry) + sum(
                s.phase == "decode" for s in eng.step_telemetry) or not all(
                    finite):
            raise AssertionError(f"wave:{label}: non-finite logits during "
                                 f"serving ({finite})")
        if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
            raise AssertionError(f"served {sorted(out)} of 4 requests")
        run = dict(out=out, eng=eng, wall=wall,
                   counts={name: fn.launches for name, fn in counters.items()},
                   designs=_read_counters(),
                   prefills=len(eng.telemetry),
                   decode=sum(s.phase == "decode"
                              for s in eng.step_telemetry))
        want = {k: 0 for k in counters}
        fma, f32 = {}, {}
        for key in per_prefill:
            n = (run["prefills"] * per_prefill[key]
                 + run["decode"] * per_decode[key])
            (fma if key.endswith("_fma") else f32 if key.endswith("_f32")
             else want)[key] = n
        run["want"], run["fma"], run["f32"] = want, fma, f32
        return run

    def check_counts(run, what):
        counts, fma, designs = run["counts"], run["fma"], run["designs"]
        print(f"[wave:{label}] {what}: launches K1 {counts['k1']}, K2 "
              f"{counts['k2']}, K3 {counts['k3']}, K4 {counts['k4']} ("
              f"{run['prefills']} prefills x {per_prefill} + "
              f"{run['decode']} decode steps x {per_decode}), K5 "
              f"{counts['k5']}, grouped K1 {counts['k1g']}, K6 "
              f"{counts['k6']}, K7 {counts['k7']}")
        if counts != run["want"]:
            raise AssertionError(f"wave:{label}, {what}: launch counts "
                                 f"{counts}, want {run['want']}")
        # Every K1 launch is a bf16 or int8 one on the wgmma design but the
        # f32 ones of the fp32 policy (MoE routers; the RWKV LoRA, grouped;
        # the dense RG-LRU gates), each on the fma design; every K2 or K3
        # launch is on the wgmma design but the f32-A ones (the packed or
        # sparse gates), which stay on the first kernel.
        got_fma = {k: designs[k] for k in fma}
        print(f"[wave:{label}] {what}: K1 fma design {got_fma['k1_fma']} "
              f"2-D, {got_fma['k1g_fma']} grouped (want {fma})")
        if got_fma != fma:
            raise AssertionError(f"wave:{label}, {what}: fma-design "
                                 f"launches {got_fma}, want {fma}")
        wgmma = {name: designs[f"{name}_wgmma"]
                 for name in ("k1", "k1g", "k2", "k2g", "k3", "k3g")}
        wgmma["k5"] = designs["k5_wgmma"] + designs["k5_split"]
        want_wgmma = dict(k1=counts["k1"] - fma["k1_fma"],
                          k1g=counts["k1g"] - fma["k1g_fma"], k2=0, k2g=0,
                          k3=0, k3g=0, k5=0)
        if fmt:
            want_wgmma[fmt] = counts[fmt] - run["f32"][f"{fmt}_f32"]
            want_wgmma[f"{fmt}g"] = counts[f"{fmt}g"]
            print(f"[wave:{label}] {what}: {run['f32'][f'{fmt}_f32']} of "
                  f"the {counts[fmt]} {fmt.upper()} launches take f32 A "
                  f"(the fp32 policy's gates) on the first kernel")
        _check_wgmma(f"wave:{label}, {what}", wgmma, want_wgmma)
        # K4's Hopper designs take head widths up to K4_MAX_D;
        # recurrentgemma's 256 run the first scalar kernel, by the rule.
        _check_k4_designs(
            f"wave:{label}, {what}", designs,
            simt=counts["k4"] if cfg.head_dim > _k4_max_d() else 0)
        return got_fma

    def summary(run, what):
        eng, wall = run["eng"], run["wall"]
        n_tok = sum(len(v) for v in run["out"].values())
        decode = [s.wall_s for s in eng.step_telemetry
                  if s.phase == "decode"]
        prefill = [w.prefill_s for w in eng.telemetry]
        out = run["out"]
        sha1 = _sha1(*(np.asarray(out[uid]) for uid in sorted(out)))
        print(f"[wave:{label}] {what}: 4 requests (prompts "
              f"{[len(p) for p in prompts]}) in {len(eng.telemetry)} waves "
              f"of 2, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} "
              f"tok/s; {run['prefills']} prefills ("
              + ", ".join(f"{1e3 * p:.2f}" for p in prefill) + " ms), "
              f"{run['decode']} decode steps (median "
              f"{1e3 * np.median(decode):.2f} ms); tokens sha1 {sha1}")
        return n_tok, wall, prefill, 1e3 * float(np.median(decode))

    # An untimed eager serve of the same requests first, so that neither
    # measured run pays the first use of these shapes (the allocator's
    # blocks, the kernels' tensor maps): both runs' prefills are the same
    # code on the caller's stream, and compare only so.
    serve_once(False)
    run = serve_once(None)
    n_tok, wall, prefill, decode_ms = summary(run, "captured")
    graphs = run["eng"].graphs
    replays = sum(g.replays for g in graphs.values())
    capture_s = sum(g.capture_s for g in graphs.values())
    pool_mb = run["eng"].graph_pool_bytes() / 2**20
    print(f"[wave:{label}] CUDA graphs: {len(graphs)} captured (chunk "
          f"widths {sorted(graphs)}), {replays} replays of "
          f"{run['decode']} decode steps, {capture_s:.3f} s capturing, "
          f"pool {pool_mb:.2f} MB")
    if sorted(graphs) != [1] or 1 + replays != run["decode"]:
        raise AssertionError(f"wave:{label}: graphs {sorted(graphs)} and "
                             f"{replays} replays for {run['decode']} decode "
                             f"steps; want one graph, every step but the "
                             f"first replayed")
    got_fma = check_counts(run, "captured")
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 weights_gb=weights / 1e9, payload_gb=payload / 1e9,
                 init_s=t_init, k6_load=load["k6"],
                 k6_stream=load["k6_stream"], prefills=run["prefills"],
                 decode_steps=run["decode"],
                 prefill_ms=[1e3 * p for p in prefill],
                 decode_step_ms=decode_ms, **run["counts"], **got_fma,
                 **run["f32"],
                 graphs=len(graphs), replays=replays, capture_s=capture_s,
                 pool_mb=pool_mb)
    out = run["out"]
    del run, graphs
    eager = serve_once(False)
    n_tok_e, wall_e, prefill_e, decode_ms_e = summary(eager, "eager step")
    check_counts(eager, "eager step")
    same = eager["out"] == out
    print(f"[wave:{label}] eager step (cuda_graphs=False): tokens "
          f"{'identical to' if same else 'DIFFER from'} the captured run's")
    if not same:
        raise AssertionError(f"wave:{label}: eager tokens {eager['out']}, "
                             f"captured {out}")
    serve.update(eager_tok_per_s=n_tok_e / wall_e,
                 eager_decode_step_ms=decode_ms_e,
                 eager_prefill_ms=[1e3 * p for p in prefill_e])
    del eager
    batch = _wave_batch(torch, model)
    serve["logit_err"] = _wave_kernel_vs_plain(
        torch, model, _open_gates(torch, params), label, batch)
    _wave_step_vs_replay(torch, model, params, label, batch, serve)
    return serve


def _wave_step_vs_replay(torch, model, params, label, batch, serve):
    """One two-row decode step after ``batch``'s prefill, eager and
    replayed from a :class:`WaveGraph` captured as the engine captures it:
    logits equal bit for bit, each from the same caches (saved after the
    prefill and copied back before each step: the recurrent states advance
    with every step); both timed and traced, into ``serve``."""
    from repro_torch.serve.engine import WaveGraph, _cache_tensors

    _, caches = model.prefill(params, batch, max_len=64)
    token = torch.tensor([[5], [7]], device="cuda")
    pos = torch.tensor(batch["tokens"].shape[1], device="cuda")
    tensors = _cache_tensors(caches)
    saved = [t.clone() for t in tensors]

    def restore():
        with torch.inference_mode():
            for t, s in zip(tensors, saved):
                t.copy_(s)

    def step():
        return model.decode_step(params, token, caches, pos)[0]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.inference_mode():
        step()
        graph = WaveGraph(model, params, caches, token, pos, stream=stream,
                          pool=torch.cuda.graph_pool_handle())
    replay = _replay_on(torch, stream, graph)
    restore()
    eager = step().clone()
    after_eager = [t.clone() for t in tensors]
    restore()
    replayed = replay().clone()
    torch.cuda.synchronize()
    if not torch.equal(eager, replayed):
        diff = (eager.float() - replayed.float()).abs().max().item()
        raise AssertionError(f"wave:{label}: a replayed decode step's "
                             f"logits differ from the eager step's by {diff}")
    if not all(torch.equal(a, b) for a, b in zip(after_eager, tensors)):
        raise AssertionError(f"wave:{label}: a replayed decode step left "
                             f"other caches than the eager step")
    print(f"[wave:{label}] one replayed two-row decode step: logits and "
          f"caches bit-equal to the eager step's")
    for key, what, fn, tag in (("", "eager", step, f"wave:{label}"),
                               ("graph_", "replayed", replay,
                                f"wave:{label}+graph")):
        enqueue, done = _decode_step_times(torch, fn)
        print(f"[wave:{label}] one {what} two-row decode step: the host "
              f"enqueues it in {enqueue:.2f} ms, the device is done after "
              f"{done:.2f} ms")
        busy, idle = _profile_decode_step(
            torch, fn, tag, done, what=f"one {what} two-row decode step")
        serve.update({f"{key}enqueue_ms": enqueue, f"{key}step_ms": done,
                      f"{key}busy_ms": busy, f"{key}idle": idle})
    del graph, replay


def _wave_batch(torch, model):
    """A two-row prefill batch, 16 tokens and a row left-padded to 16 from
    9 (stubbed zero audio frames for whisper; for a VLM image embeddings
    drawn from a seed, not the engine's zeros, so that its cross blocks see
    states)."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(2, cfg.vocab, (2, 16), generator=gen,
                         device="cuda", dtype=torch.int32)
    toks[1, :7] = 0
    batch = {"tokens": toks}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros(
            (2, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device="cuda")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (2, cfg.n_image_tokens, cfg.d_model), generator=gen,
            device="cuda").to(torch.bfloat16)
    return batch


def _open_gates(torch, params, gates=(0.5, 0.5)):
    """``params`` with every cross block's gates (attention, MLP) at
    ``gates``, each a tensor of its own: the init draws them 0, a closed
    gate hides its branch from a comparison, and at 0 every gradient of
    the block's attention and MLP is exactly zero."""
    def gate(like, value):
        return torch.full_like(like.detach(), value)
    return dict(params, layers=[
        dict(layer, gate_attn=gate(layer["gate_attn"], gates[0]),
             gate_mlp=gate(layer["gate_mlp"], gates[1]))
        if "gate_attn" in layer else layer for layer in params["layers"]])


# A recurrent model's logits can move with the order of an f32 sum by
# more than LOGIT_REL_TOL: with random weights, rwkv6-1.6b's moved by 9.5
# (prefill) and 11.1 % (decode) of its largest |logit|, and
# recurrentgemma-2b's by 2.1 %, between the plain versions and the same
# function summed in f64 (whisper's 1.2 %, phi3's 1.7 %).  A path whose
# plain version misses the bound so in its prefill or its decode step is
# held to the model's own spread instead: the kernels' logits no farther
# from the f64 sums than EXACT_SPREAD times the plain version's (both are
# f32 sums, one bf16 rounding an output, in another order), and each
# layer, fed the plain run's input, within LOGIT_REL_TOL of its plain
# output's largest |value|.
EXACT_SPREAD = 1.5


def _wave_kernel_vs_plain(torch, model, params, label, batch):
    """One full-width prefill and one decode step through the kernels,
    through the plain versions and through the plain versions summed in
    f64: the kernels' logits within the policy's bound (``LOGIT_REL_TOL``)
    of the plain version's, or, on a path where the plain version misses
    that bound against the f64 sums, held to the model's spread
    (``EXACT_SPREAD``); a recurrent model's or a spread path's layers also
    one by one (``_layers_vs_plain``)."""
    token = torch.tensor([[11], [13]], device="cuda")
    pos = batch["tokens"].shape[1]
    v = model.cfg.vocab
    runs = []
    for plain, exact in ((False, False), (True, False), (True, True)):
        with _plain_versions(enabled=plain, exact=exact):
            logits, caches = model.prefill(params, batch, max_len=64)
            step, _ = model.decode_step(params, token, caches, pos)
        runs.append((logits.float()[:, :v], step.float()[:, :v]))
        del caches
    rel = LOGIT_REL_TOL["int8" if model.policy == "int8" else "bf16"]
    rows = []
    for i, what in enumerate(("prefill", "decode step")):
        lk, lp, lx = runs[0][i], runs[1][i], runs[2][i]
        diff = (lk - lp).abs()
        err, scale = diff.max().item(), lp.abs().max().item()
        plain_x = (lp - lx).abs().max().item()
        kern_x = (lk - lx).abs().max().item()
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        print(f"[wave:{label}] one full-width {what}, kernels vs plain "
              f"versions: max |logit diff| {err:.3e}, mean "
              f"{diff.mean().item():.3e} (bound {rel} x max |logit| = "
              f"{rel * scale:.3e}), argmax agreement {agree:.2f}; against "
              f"the f64 sums: plain {plain_x:.3e} ({plain_x / scale:.4f} "
              f"x max |logit|), kernels {kern_x:.3e}")
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{what}: non-finite kernel logits")
        rows.append((what, err, scale, plain_x, kern_x))
    spread = any(plain_x > rel * scale for _, _, scale, plain_x, _ in rows)
    for what, err, scale, plain_x, kern_x in rows:
        if not spread and err > rel * scale:
            raise AssertionError(f"{what}: kernel and plain logits differ "
                                 f"by {err:.3e}")
        if spread and kern_x > EXACT_SPREAD * plain_x:
            raise AssertionError(
                f"{what}: the kernels' logits are {kern_x:.3e} from the "
                f"f64 sums, the plain version's {plain_x:.3e}")
    if spread:
        print(f"[wave:{label}] the plain version's own logits move by more "
              f"than {rel} x max |logit| with the order of its f32 sums: "
              f"the kernels are held to {EXACT_SPREAD} x its distance from "
              f"the f64 sums (" + ", ".join(
                  f"{what} {kern_x:.3e} <= {EXACT_SPREAD * plain_x:.3e}"
                  for what, _, _, plain_x, kern_x in rows) + ")")
    # The recurrent kinds' paths are held layer by layer in every form.
    if spread or {"rwkv", "rglru"} & set(model.cfg.pattern):
        _layers_vs_plain(torch, model, params, label, batch)
    return max(err for _, err, _, _, _ in rows)


def _layers_vs_plain(torch, model, params, label, batch):
    """Each layer of one full-width prefill, fed the plain run's input to
    it, through the kernels and through the plain versions: outputs within
    the policy's LOGIT_REL_TOL of the plain output's largest |value|."""
    from repro_torch.models import transformer as T

    inputs, inner = [], T._block_fwd

    def record(kind, layer, x, ctx):
        inputs.append((kind, layer, x, dict(ctx, collect_cache=False)))
        return inner(kind, layer, x, ctx)

    T._block_fwd = record
    try:
        with _plain_versions():
            model.prefill(params, batch, max_len=64)
    finally:
        T._block_fwd = inner
    rel = LOGIT_REL_TOL["int8" if model.policy == "int8" else "bf16"]
    worst = 0.0
    for i, (kind, layer, x, ctx) in enumerate(inputs):
        got, _, _ = inner(kind, layer, x, ctx)
        with _plain_versions():
            want, _, _ = inner(kind, layer, x, ctx)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        worst = max(worst, err / scale)
        if not err <= rel * scale:
            raise AssertionError(f"wave:{label}: layer {i} ({kind}) differs "
                                 f"by {err:.3e} of {scale:.3e}")
    print(f"[wave:{label}] each of the {len(inputs)} layers fed the plain "
          f"run's input: kernels vs plain within {worst:.3e} x the layer "
          f"output's max |value| (bound {rel})")


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ phase 8

# Training shapes: batch 4 x seq 128 = 512 tokens a step.
TRAIN_TOKENS = 512
# granite's training capacity: round(1.25 * top-8 * 128 / 32 experts) = 40
# slots per expert and sequence, 4 sequences: 160 rows per expert.
GRANITE_TRAIN_ROWS = 4 * 40
GRANITE_VOCAB_PADDED = 49280
# K1 trans_a cases, dW = A^T B with A (T, M) and B (T, N): (name, model, M,
# N, dtype, per-step launches, G).  granite: wq/wo 1024 x 1024, wk/wv
# 1024 x 512, the f32 router 1024 x 32, the tied head's embedding
# gradient (V_p x 1024, A = the logits' cotangent), the expert stacks
# (grouped, 160 rows each); phi3-mini's projections (4 layers).
TRANS_A_CASES = [
    ("g-wq/wo", "granite", 1024, 1024, "bfloat16", 2 * GRANITE_LAYERS, None),
    ("g-wk/wv", "granite", 1024, 512, "bfloat16", 2 * GRANITE_LAYERS, None),
    ("g-router", "granite", 1024, 32, "float32", GRANITE_LAYERS, None),
    ("g-embed", "granite", GRANITE_VOCAB_PADDED, 1024, "bfloat16", 1, None),
    ("g-experts-up/gate", "granite", 1024, 512, "bfloat16",
     2 * GRANITE_LAYERS, GRANITE_EXPERTS),
    ("g-experts-down", "granite", 512, 1024, "bfloat16", GRANITE_LAYERS,
     GRANITE_EXPERTS),
    ("phi3-qkvo", "phi3", 3072, 3072, "bfloat16", 4 * 4, None),
    ("phi3-up/gate", "phi3", 3072, 8192, "bfloat16", 2 * 4, None),
    ("phi3-down", "phi3", 8192, 3072, "bfloat16", 4, None),
    ("phi3-head", "phi3", 3072, 32128, "bfloat16", 1, None),
]
# The dW GEMMs of the cross and recurrent kinds' training paths
# (``TRAIN_PATHS``, 512 tokens a step), with the rows T each reads where
# it is not 512: (name, model, M, N, dtype, per-step launches, G, T).
# llama-3.2-vision-11b at 5 layers (4 dense, 1 cross; d 4096, GQA 32:8,
# d_ff 14336, untied head 128256): the cross block's wk / wv read the
# 4 x 1600 image states.  rwkv6-1.6b at 4 layers (d 2048, d_ff 7168,
# untied head 65536): the time mix's lora_a (2048 x 160), wr / wk / wv /
# wg / wo and w_lora_a (2048 x 64), the channel mix's ck, cv, cr.
# recurrentgemma-2b at 5 layers (4 rglru, 1 attn_local; d = lru width
# 2560, d_ff 7680, MQA 10:1 of D 256, the tied embedding 256000 x 2560):
# w_x, w_y, w_out, the MLP, the local attention's projections.  All bf16
# on the wgmma design: the fp32-policy dW of these paths (rwkv6's grouped
# LoRA, the RG-LRU gates) are FMA_KIND_TRAIN_CASES'.
V_VISION, V_RWKV, V_RGEMMA = 128256, 65536, 256000
TRANS_A_KIND_CASES = [
    ("v-wq/wo", "vision", 4096, 4096, "bfloat16", 10, None, TRAIN_TOKENS),
    ("v-wk/wv", "vision", 4096, 1024, "bfloat16", 8, None, TRAIN_TOKENS),
    ("v-cross-wk/wv", "vision", 4096, 1024, "bfloat16", 2, None, 4 * 1600),
    ("v-gate/up", "vision", 4096, 14336, "bfloat16", 10, None,
     TRAIN_TOKENS),
    ("v-down", "vision", 14336, 4096, "bfloat16", 5, None, TRAIN_TOKENS),
    ("v-head", "vision", 4096, V_VISION, "bfloat16", 1, None, TRAIN_TOKENS),
    ("r-lora_a", "rwkv6", 2048, 160, "bfloat16", 4, None, TRAIN_TOKENS),
    ("r-proj", "rwkv6", 2048, 2048, "bfloat16", 24, None, TRAIN_TOKENS),
    ("r-w_lora_a", "rwkv6", 2048, 64, "bfloat16", 4, None, TRAIN_TOKENS),
    ("r-ck", "rwkv6", 2048, 7168, "bfloat16", 4, None, TRAIN_TOKENS),
    ("r-cv", "rwkv6", 7168, 2048, "bfloat16", 4, None, TRAIN_TOKENS),
    ("r-head", "rwkv6", 2048, V_RWKV, "bfloat16", 1, None, TRAIN_TOKENS),
    ("g-proj", "rgemma", 2560, 2560, "bfloat16", 14, None, TRAIN_TOKENS),
    ("g-wk/wv", "rgemma", 2560, 256, "bfloat16", 2, None, TRAIN_TOKENS),
    ("g-gate/up", "rgemma", 2560, 7680, "bfloat16", 10, None,
     TRAIN_TOKENS),
    ("g-down", "rgemma", 7680, 2560, "bfloat16", 5, None, TRAIN_TOKENS),
    ("g-embed", "rgemma", V_RGEMMA, 2560, "bfloat16", 1, None,
     TRAIN_TOKENS),
]


def phase_k1_trans_a(torch, timer):
    """K1 with A read (K, M): the weight gradients of a training step at
    512 tokens (``TRANS_A_CASES``; ``TRANS_A_KIND_CASES``: the cross and
    recurrent kinds' paths), bf16 operands (f32 for the router, on the
    fma design) with f32 outputs, each against its plain version and
    beside ``torch.matmul(a.t(), b)``; then the deterministic check (two
    launches, the same bits)."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    steps = collections.defaultdict(StepSum)
    router_scalar_ms = 0.0
    has_fma = _rule("k1_fma_tile") is not None
    for name, model, m, n, dt, per_step, g, *rows in (TRANS_A_CASES
                                                      + TRANS_A_KIND_CASES):
        dtype = getattr(torch, dt)
        t = rows[0] if rows else GRANITE_TRAIN_ROWS if g else TRAIN_TOKENS
        lead = (g,) if g else ()
        a = torch.randn(*lead, t, m, generator=gen, device="cuda").to(dtype)
        b = torch.randn(*lead, t, n, generator=gen, device="cuda").to(dtype)
        fn = mpgemm_grouped if g else mpgemm
        spec = GemmSpec(grouped=bool(g), trans_a=True)

        def kern():     # the router's dW: the fp32 policy's f32 FMA
            return fn(a, b, spec=spec, out_dtype=torch.float32,
                      f32_fma=dtype == torch.float32)

        def plain():
            return mpgemm_plain(a, b, trans_a=True, out_dtype=torch.float32)

        def library():
            return torch.matmul(a.transpose(-1, -2), b).float()

        def scalar():
            return _k1_scalar(torch, a, b, trans_a=True,
                              out_dtype=torch.float32)

        (got, design), again, ref = _k1_design_of(kern), kern(), plain()
        router = dtype == torch.float32
        if router and has_fma and design != "fma":
            raise AssertionError(f"K1 trans_a {name}: ran {design}, want "
                                 f"fma")
        if design == "fma":
            _check_fma_bits(torch, f"K1 trans_a {name}", got, again,
                            scalar())
        torch.cuda.synchronize()
        if t <= TRAIN_TOKENS:
            err = _check_close(torch, f"K1 trans_a {name}", got, ref,
                               TOL["float32"])
        else:
            # A reduction longer than the 512 rows TOL["float32"] was set
            # for (llama-vision's cross K/V over 6400 image rows): there the
            # tensor cores' f32 sums of bf16 products move by more than
            # 1e-4 near zero from any other order's.  Held to the f64 sums
            # by the leaf's scale instead, as a training step's gradients
            # are (rtol 1e-4 of the largest |value|); the plain version's
            # distance is printed beside it.
            exact = torch.matmul(a.double().transpose(-1, -2), b.double())
            kx = (got.double() - exact).abs().max().item()
            px = (ref.double() - exact).abs().max().item()
            scale = exact.abs().max().item()
            err = (got - ref).abs().max().item()
            bound = TOL["float32"]["rtol"] * scale
            print(f"[k1-trans_a] {name}: K = {t}, against the f64 sums: "
                  f"kernel {kx:.3e}, plain {px:.3e} (bound 1e-4 x max "
                  f"|value| = {bound:.3e}); kernel vs plain {err:.3e}")
            if not (kx <= bound and torch.isfinite(got).all()):
                raise AssertionError(f"K1 trans_a {name}: {kx:.3e} from the "
                                     f"f64 sums, bound {bound:.3e}")
            del exact
        if not torch.equal(got, again):
            raise AssertionError(f"K1 trans_a {name}: two launches differ")
        del got, again, ref
        groups = g or 1
        n_bytes = groups * (t * (m + n) * a.element_size() + m * n * 4)
        n_ops = 2 * groups * m * n * t
        bound, bound_by = _bound_ms(n_bytes, n_ops, _peak_of(design, dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        sc_ms = timer(scalar) if router else None
        print(f"[k1-trans_a] {name:>18} {dt:>8} {design:>5} G={g or 1:<2} "
              f"M={m:<6} "
              f"N={n:<6} K={t}: err {err:.2e} (f32 out, rtol 1e-4, atol "
              f"1e-4), deterministic"
              + (", bit-equal to the scalar loop" if design == "fma" else "")
              + f"  kernel {ms:.4f} ms"
              + (f"  scalar loop {sc_ms:.4f}" if router else "")
              + f"  plain {plain_ms:.4f}  library {lib_ms:.4f}  bound "
              f"{bound:.4f} ({bound_by})  {n_ops / ms / 1e9:.1f} TFLOP/s")
        key = f"{model}-grouped" if g else model
        for key in (key, "granite-router") if router else (key,):
            steps[key].max_abs_err = max(steps[key].max_abs_err, err)
            steps[key].add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                           n_ops)
        if router:
            router_scalar_ms += per_step * sc_ms
        del a, b
    rows = {}
    for key, acc in steps.items():
        rows[key] = acc.row("float32" if key == "granite-router"
                            else "bfloat16")
        if key == "granite-router":
            rows[key]["scalar_ms"] = router_scalar_ms
        print(f"[k1-trans_a] the dW GEMMs of one {key} training step "
              f"({acc.launches} launches): kernel {acc.ms:.3f} ms, "
              + (f"scalar loop {router_scalar_ms:.3f} ms, "
                 if key == "granite-router" else "")
              + f"plain {acc.plain_ms:.3f} ms, library {acc.library_ms:.3f} "
              f"ms, bound {acc.bound_ms:.3f} ms ({rows[key]['bound_by']})")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# K1's fma design (the fp32 policy's f32 FMA) at the shapes of a granite
# training step under ``--policy fp32`` (512 tokens, 24 layers, remat; 32
# experts of 160 rows): (name, G, M, N, K, trans_a, trans_b, epilogue
# kind, activation, launches per step).  Forward (twice: remat), dX
# (``trans_b``) and dW (``trans_a``) of wq/wo (1024 x 1024), wk/wv (1024 x
# 512) and the router (1024 x 32); the tied head (the (49280, 1024)
# embedding read as B^T), its dX and dW; the expert stacks' up/gate (the
# gate fused, and its z again in the backward) and down.  The launches add
# up to ``_want_train_launches``' 484 2-D and 312 grouped K1 launches a
# step.
L_, T_, E_ = GRANITE_LAYERS, TRAIN_TOKENS, GRANITE_EXPERTS
R_, V_ = GRANITE_TRAIN_ROWS, GRANITE_VOCAB_PADDED
FMA_TRAIN_CASES = [
    ("wq/wo", 1, T_, 1024, 1024, False, False, "linear", None, 4 * L_),
    ("wk/wv", 1, T_, 512, 1024, False, False, "linear", None, 4 * L_),
    ("router", 1, T_, 32, 1024, False, False, "linear", None, 2 * L_),
    ("wq/wo dX", 1, T_, 1024, 1024, False, True, "linear", None, 2 * L_),
    ("wk/wv dX", 1, T_, 1024, 512, False, True, "linear", None, 2 * L_),
    ("router dX", 1, T_, 1024, 32, False, True, "linear", None, L_),
    ("wq/wo dW", 1, 1024, 1024, T_, True, False, "linear", None, 2 * L_),
    ("wk/wv dW", 1, 1024, 512, T_, True, False, "linear", None, 2 * L_),
    ("router dW", 1, 1024, 32, T_, True, False, "linear", None, L_),
    ("head", 1, T_, V_, 1024, False, True, "linear", None, 2),
    ("head dX", 1, T_, 1024, V_, False, False, "linear", None, 1),
    ("head dW", 1, V_, 1024, T_, True, False, "linear", None, 1),
    ("experts up/gate", E_, R_, 512, 1024, False, False, "gated", "silu",
     5 * L_),
    ("experts down", E_, R_, 1024, 512, False, False, "linear", None,
     2 * L_),
    ("experts up/gate dX", E_, R_, 1024, 512, False, True, "linear", None,
     2 * L_),
    ("experts down dX", E_, R_, 512, 1024, False, True, "linear", None, L_),
    ("experts up/gate dW", E_, 1024, 512, R_, True, False, "linear", None,
     2 * L_),
    ("experts down dW", E_, 512, 1024, R_, True, False, "linear", None, L_),
]
# The fp32 policy's products in the cross and recurrent kinds' bf16
# training paths (``TRAIN_PATHS``, 512 tokens, remat): (row, name, G, M,
# N, K, trans_a, trans_b, epilogue kind, activation, launches per step).
# rwkv6-1.6b at 4 layers: the 5-stream LoRA (K 32 -> 2048) forward twice,
# its dX and dW; recurrentgemma-2b at 5 layers: the RG-LRU gates (2560 x
# 2560, two a layer, four layers) forward twice, dX and dW.  The launches
# add up to ``_want_train_launches``' ``k1g_fma`` (16) and ``k1_fma`` (32).
FMA_KIND_TRAIN_CASES = [
    ("rwkv6-lora-train", "rwkv6 LoRA", 5, TRAIN_TOKENS, 2048, 32, False,
     False, "linear", None, 8),
    ("rwkv6-lora-train", "rwkv6 LoRA dX", 5, TRAIN_TOKENS, 32, 2048, False,
     True, "linear", None, 4),
    ("rwkv6-lora-train", "rwkv6 LoRA dW", 5, 32, 2048, TRAIN_TOKENS, True,
     False, "linear", None, 4),
    ("rgemma-gates-train", "rgemma gates", 1, TRAIN_TOKENS, 2560, 2560,
     False, False, "linear", None, 16),
    ("rgemma-gates-train", "rgemma gates dX", 1, TRAIN_TOKENS, 2560, 2560,
     False, True, "linear", None, 8),
    ("rgemma-gates-train", "rgemma gates dW", 1, 2560, 2560, TRAIN_TOKENS,
     True, False, "linear", None, 8),
]
# The router at every M a step gives it (decode, chunks, 17 rows: the
# first ragged M past the 16-row tile; 512 tokens), ragged M, N and K
# edges of every transpose pair (K not a multiple of the stage, M and N
# not of the tile), and each epilogue kind, 2-D and grouped: (name, G, M,
# N, K, trans_a, trans_b, kind, activation, bias, beta, output dtype).
FMA_EDGE_CASES = [
    (f"router m={m}", 1, m, 32, 1024, False, False, "linear", None, False,
     0.0, "float32") for m in (1, 2, 16, 17, 32, 512)
] + [
    ("ragged", 3, 37, 44, 1004, False, False, "linear", None, False, 0.0,
     "float32"),
    ("ragged trans_a", 3, 36, 44, 999, True, False, "linear", None, False,
     0.0, "float32"),
    ("ragged trans_b", 3, 37, 45, 1004, False, True, "linear", None, False,
     0.0, "float32"),
    ("ragged trans_a+b", 3, 36, 45, 1004, True, True, "linear", None, False,
     0.0, "float32"),
    ("K 9, trans_a", 1, 20, 12, 9, True, False, "linear", None, False, 0.0,
     "float32"),
    ("bias gelu", 1, 33, 40, 200, False, False, "linear", "gelu", True, 0.0,
     "float32"),
    ("gated silu, bf16 out", 2, 6, 40, 200, False, False, "gated", "silu",
     False, 0.0, "bfloat16"),
    ("residual", 1, 130, 136, 72, False, True, "residual", None, True, 0.0,
     "float32"),
    ("quant_in", 2, 40, 36, 64, False, False, "quant_in", "silu", False,
     0.0, "float32"),
    ("quant_in residual", 1, 8, 36, 64, True, False, "quant_in_residual",
     None, False, 0.0, "bfloat16"),
    ("beta*C", 2, 200, 264, 300, False, False, "linear", None, True, 0.5,
     "float32"),
]
del L_, T_, E_, R_, V_


def phase_k1_fma(torch, timer):
    """K1's fma design (``csrc/mpgemm_fma.cu``, what ``mpgemm(...,
    f32_fma=True)`` runs for aligned f32 operands: the fp32 policy's
    products) at the shapes of a granite training step under fp32
    (``FMA_TRAIN_CASES``), of the recurrent kinds' f32 products in their
    training steps (``FMA_KIND_TRAIN_CASES``) and at ``FMA_EDGE_CASES``: each case bit-equal
    to the scalar loop (``csrc/mpgemm.cu``, launched directly), the same
    bits from two launches, within f32's 1e-4 of the plain version (bf16
    outputs: the bf16 tolerance), timed beside the scalar loop, the plain
    version and ``torch.matmul`` (f32 with TF32 off; the epilogue, where
    there is one, in torch ops after it), with its tile
    (``k1_fma_tile``).  -> rows: one granite fp32 training step's 2-D and
    grouped products (each case weighted by its launches a step), the
    routers' forward, dX and dW of a training step (the f32 products of a
    bf16 step), rwkv6's LoRA and recurrentgemma's gates in their bf16
    training steps (``FMA_KIND_TRAIN_CASES``), the router at decode (M =
    2) and the edge cases."""
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(12)
    tile_of = _rule("k1_fma_tile")
    cases = [dict(name=name, g=g, m=m, n=n, k=k, ta=ta, tb=tb, kind=kind,
                  act=act, bias=False, beta=0.0, out="float32",
                  per_step=per_step, train=True)
             for name, g, m, n, k, ta, tb, kind, act, per_step
             in FMA_TRAIN_CASES]
    cases += [dict(key=key, name=name, g=g, m=m, n=n, k=k, ta=ta, tb=tb,
                   kind=kind, act=act, bias=False, beta=0.0, out="float32",
                   per_step=per_step, train=True)
              for key, name, g, m, n, k, ta, tb, kind, act, per_step
              in FMA_KIND_TRAIN_CASES]
    cases += [dict(name=name, g=g, m=m, n=n, k=k, ta=ta, tb=tb, kind=kind,
                   act=act, bias=bias, beta=beta, out=out, per_step=0,
                   train=False)
              for name, g, m, n, k, ta, tb, kind, act, bias, beta, out
              in FMA_EDGE_CASES]
    sums = {"granite-fp32-train-2d": StepSum(),
            "granite-fp32-train-grouped": StepSum(),
            "granite-routers-train": StepSum(),
            "router-decode": StepSum(), "edges": StepSum(),
            "rwkv6-lora-train": StepSum(), "rgemma-gates-train": StepSum()}
    scalar_sums = dict.fromkeys(sums, 0.0)
    f32 = torch.float32
    for c in cases:
        g, m, n, k, ta, tb = c["g"], c["m"], c["n"], c["k"], c["ta"], c["tb"]
        grouped = g > 1 or c["train"] and c["name"].startswith("experts")
        lead = (g,) if grouped else ()
        out_dtype = getattr(torch, c["out"])
        a = torch.randn(*lead, *((k, m) if ta else (m, k)), generator=gen,
                        device="cuda")
        b = torch.randn(*lead, *((n, k) if tb else (k, n)), generator=gen,
                        device="cuda") * k ** -0.5
        bias = (torch.randn(*lead, n, generator=gen, device="cuda")
                if c["bias"] else None)
        extras = ()
        if c["kind"].startswith("quant_in"):
            extras = (torch.rand(*lead, m, 1, generator=gen, device="cuda")
                      + 0.5,)
        if c["kind"] in ("gated", "residual", "quant_in_residual"):
            extras += (torch.randn(*lead, m, n, generator=gen,
                                   device="cuda").to(out_dtype),)
        cc = (torch.randn(*lead, m, n, generator=gen, device="cuda")
              if c["beta"] else None)
        ep = EpilogueSpec(kind=c["kind"], activation=c["act"],
                          alpha=1.5 if c["beta"] else 1.0, beta=c["beta"])
        fn = mpgemm_grouped if grouped else mpgemm
        spec = GemmSpec(grouped=grouped, trans_a=ta, trans_b=tb)
        kw = dict(bias=bias, extras=extras, c=cc, epilogue=ep,
                  out_dtype=out_dtype)
        at = a.transpose(-1, -2) if ta else a
        bt = b.transpose(-1, -2) if tb else b

        def kern():
            return fn(a, b, spec=spec, f32_fma=True, **kw)

        def scalar():
            return _k1_scalar(torch, a, b, trans_a=ta, trans_b=tb, **kw)

        def plain():
            return mpgemm_plain(a, b, trans_a=ta, trans_b=tb, **kw)

        def library():
            acc = torch.matmul(at, bt)
            if c["kind"] == "linear" and bias is None and cc is None:
                return acc
            return apply_epilogue(
                ep, acc, c=cc, extras=extras,
                bias=None if bias is None else bias.unsqueeze(-2)).to(
                    out_dtype)

        label = f"K1 fma {c['name']}"
        (got, design), ref = _k1_design_of(kern), plain()
        if tile_of is not None and design != "fma":
            raise AssertionError(f"{label}: ran {design}, want fma")
        if design == "fma":
            _check_fma_bits(torch, label, got, kern(), scalar())
        torch.cuda.synchronize()
        tol = TOL[c["out"]]
        err = _check_close(torch, label, got, ref, tol)
        del got, ref
        esz = out_dtype.itemsize
        n_bytes = 4 * g * (m * k + k * n) + g * m * n * esz * (
            1 + sum(t.shape[-1] == n for t in extras)) + 4 * g * m * sum(
            t.shape[-1] == 1 for t in extras) + (
            4 * bias.numel() if bias is not None else 0) + (
            4 * cc.numel() if cc is not None else 0)
        n_ops = 2 * g * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops, "float32")
        ms, sc_ms = timer(kern), timer(scalar)
        plain_ms, lib_ms = timer(plain), timer(library)
        tile = tile_of(m, n, k, g) if tile_of else None
        print(f"[k1-fma] {c['name']:>22} {design:>4} "
              + (f"{tile[0]}x{tile[1]} " if tile else "")
              + f"G={g:<2} M={m:<5} N={n:<5} K={k:<5} ta={ta:d} tb={tb:d} "
              f"{c['kind']}/{c['act']} -> {c['out']}: err {err:.2e} (rtol "
              f"{tol['rtol']}, atol {tol['atol']}), bit-equal to the scalar "
              f"loop, deterministic  kernel {ms:.4f} ms  scalar loop "
              f"{sc_ms:.4f}  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.4f} ({bound_by})  {n_ops / ms / 1e9:.2f} "
              f"TFLOP/s")
        if c["train"]:
            key = c.get("key") or ("granite-fp32-train-grouped" if grouped
                                   else "granite-fp32-train-2d")
            per = c["per_step"]
        else:
            key, per = ("router-decode" if c["name"] == "router m=2"
                        else "edges"), 1
        keys = (key,)
        if key == "router-decode":
            keys = (key, "edges")
        elif c["train"] and c["name"].startswith("router"):
            keys = (key, "granite-routers-train")   # bf16 training's too
        for k_ in keys:
            sums[k_].add(per, ms, plain_ms, lib_ms, bound, n_bytes, n_ops)
            sums[k_].max_abs_err = max(sums[k_].max_abs_err, err)
            scalar_sums[k_] += per * sc_ms
        del a, b, bias, extras, cc, at, bt
    rows = {}
    for key, acc in sums.items():
        row = rows[key] = acc.row("float32")
        row["scalar_ms"] = scalar_sums[key]
        row["launches_per_step"] = acc.launches
        print(f"[k1-fma] {key} ({acc.launches} launches): kernel "
              f"{row['ms']:.3f} ms, scalar loop {row['scalar_ms']:.3f} ms, "
              f"plain {row['plain_ms']:.3f} ms, library "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------------------- phase 6c

# The six architectures the port serves besides phi3-mini, granite and
# whisper (phase 7's paths): label -> (architecture, depth served).
ARCH_K1_PATHS = {
    "starcoder2": ("starcoder2-3b", None),
    "phi3-medium": ("phi3-medium-14b", None),
    "mixtral": ("mixtral-8x22b", MIXTRAL_LAYERS),
    "vision": ("llama-3.2-vision-11b", None),
    "rwkv6": ("rwkv6-1.6b", None),
    "rgemma": ("recurrentgemma-2b", None),
}


def _decode_gemms(cfg, n_layers):
    """The K1 launches of one decode step of ``cfg`` cut to ``n_layers``,
    from its block kinds: {(G, K, N, epilogue kind, activation, bias,
    trans_b, f32): launches}.  ``f32`` marks the fp32 policy's products
    (MoE routers, the RWKV LoRA, the RG-LRU gates: f32 operands and output
    on K1's fma design); the expert GEMMs and the LoRA are grouped (G > 1,
    f32 outputs).  The dense block's residual rides its down projection;
    a cross block's and the recurrent blocks' MLPs carry none."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    gelu = cfg.mlp == "gelu"
    out = {}

    def add(g, k, n, kind="linear", act=None, bias=False, tb=False,
            f32=False):
        key = (g, k, n, kind, act, bias, tb, f32)
        out[key] = out.get(key, 0) + 1

    def mlp(residual):
        down = "residual" if residual else "linear"
        if gelu:
            add(1, d, f, act="gelu", bias=True)
            add(1, f, d, down, bias=True)
        else:
            add(1, d, f)
            add(1, d, f, "gated", "silu")
            add(1, f, d, down)

    for kind in cfg.pattern[:n_layers]:
        if kind in ("dense", "attn_local", "moe"):
            add(1, d, q)
            add(1, d, kv)
            add(1, d, kv)
            add(1, q, d)
            if kind != "moe":
                mlp(residual=True)
                continue
            e = cfg.n_experts
            add(1, d, e, f32=True)
            add(e, d, f)
            add(e, d, f, "gated", "silu")
            add(e, f, d)
        elif kind == "cross":
            add(1, d, q)
            add(1, q, d)
            mlp(residual=False)
        elif kind == "rwkv":
            for n in (5 * 32, 64, d, d, d, d, d, f, d):
                add(1, d, n)           # lora_a, w_lora_a, wr..wg, wo, ck, cr
            add(1, f, d)               # cv
            add(5, 32, d, f32=True)    # the LoRA's five streams
        elif kind == "rglru":
            w = cfg.lru_width or d
            add(1, d, w)
            add(1, d, w)
            add(1, w, w, f32=True)
            add(1, w, w, f32=True)
            add(1, w, d)
            mlp(residual=False)
        else:
            raise ValueError(kind)
    vp = -(-cfg.vocab // 128) * 128
    add(1, d, vp, tb=cfg.tie_embeddings)
    return out


def phase_k1_archs(torch, timer):
    """K1 at every GEMM shape of one full-width decode step (M = 2 rows) of
    the six newer architectures (``_decode_gemms``): bf16 on the wgmma
    design; the fp32 policy's products on the fma design, bit-equal to the
    scalar loop (``_k1_scalar``) and to a second launch; every case within
    its tolerance of the plain version, timed beside it, one
    ``torch.matmul`` (f32 with TF32 off; the epilogue in torch ops after
    it) and the bound.  -> rows by model: ``LABEL`` (the 2-D launches,
    the f32 ones among them), ``LABEL-fma`` (the 2-D f32 ones alone) and
    ``LABEL-grouped``, each one decode step's launches weighted."""
    from repro_torch.configs import base as cb
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(17)
    f32, bf16, m = torch.float32, torch.bfloat16, 2
    rows = {}
    for label, (arch, n_layers) in ARCH_K1_PATHS.items():
        cfg = cb.get(arch)
        steps = {key: StepSum() for key in (label, f"{label}-fma",
                                            f"{label}-grouped")}
        scalar_ms = dict.fromkeys(steps, 0.0)
        for (g, k, n, kind, act, has_bias, tb, fp32), per_step in \
                _decode_gemms(cfg, n_layers or cfg.n_layers).items():
            dt = f32 if fp32 else bf16
            out_dtype = f32 if fp32 or g > 1 else bf16
            lead = (g,) if g > 1 else ()
            a = torch.randn(*lead, m, k, generator=gen, device="cuda").to(dt)
            w = (torch.randn(*lead, *((n, k) if tb else (k, n)),
                             generator=gen, device="cuda")
                 * (2.0 / (k + n)) ** 0.5).to(dt)
            bias = (torch.randn(n, generator=gen, device="cuda")
                    if has_bias else None)
            extras = () if kind == "linear" else (
                torch.randn(*lead, m, n, generator=gen,
                            device="cuda").to(out_dtype),)
            ep = EpilogueSpec(kind=kind, activation=act)
            fn = mpgemm_grouped if g > 1 else mpgemm
            kw = dict(bias=bias, extras=extras, epilogue=ep,
                      out_dtype=out_dtype)

            def kern():
                return fn(a, w, spec=GemmSpec(grouped=g > 1, trans_b=tb),
                          f32_fma=fp32, **kw)

            def plain():
                return mpgemm_plain(a, w, trans_b=tb, **kw)

            def library():
                acc = torch.matmul(a, w.transpose(-1, -2) if tb else w)
                return apply_epilogue(
                    ep, acc.float(), extras=extras,
                    bias=None if bias is None else bias.reshape(1, -1)).to(
                        out_dtype)

            def scalar():
                return _k1_scalar(torch, a, w, trans_b=tb, **kw)

            what = (f"K1 {label} G={g} k={k} n={n} {kind}/{act}"
                    f"{' bias' if has_bias else ''}{' trans_b' if tb else ''}"
                    f" {_dtype_name(dt)}")
            (got, design), ref = _k1_design_of(kern), plain()
            want = "fma" if fp32 else "wgmma"
            if design != want:
                raise AssertionError(f"{what}: ran {design}, want {want}")
            if fp32:
                _check_fma_bits(torch, what, got, kern(), scalar())
            torch.cuda.synchronize()
            err = _check_close(torch, what, got, ref,
                               TOL[_dtype_name(out_dtype)])
            esz = a.element_size()
            n_bytes = (g * (m * k + k * n) * esz
                       + g * m * n * out_dtype.itemsize * (1 + len(extras))
                       + (4 * n if bias is not None else 0))
            n_ops = 2 * g * m * n * k
            bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(dt))
            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
            sc_ms = timer(scalar) if fp32 else None
            print(f"[k1-archs] {what:>58} x{per_step:<3} {design:>5}: err "
                  f"{err:.2e}  kernel {ms:.4f} ms"
                  + (f"  scalar loop {sc_ms:.4f}" if fp32 else "")
                  + f"  plain {plain_ms:.4f}  library {lib_ms:.4f}  bound "
                  f"{bound:.4f} ({bound_by})")
            keys = ([f"{label}-grouped"] if g > 1 else
                    [label, f"{label}-fma"] if fp32 else [label])
            for key in keys:
                steps[key].add(per_step, ms, plain_ms, lib_ms, bound,
                               n_bytes, n_ops)
                steps[key].max_abs_err = max(steps[key].max_abs_err, err)
                if fp32:
                    scalar_ms[key] += per_step * sc_ms
            del a, w, bias, extras, got, ref
        for key, step in steps.items():
            if not step.launches:
                continue
            # f32 rows: the 2-D fma launches, and grouped ones on fma.
            on_fma = key.endswith("-fma") or (key.endswith("-grouped")
                                              and scalar_ms[key] > 0)
            row = rows[key] = step.row("float32" if on_fma else "bfloat16")
            if on_fma:
                row["scalar_ms"] = scalar_ms[key]
            print(f"[k1-archs] one full-width {key} decode step "
                  f"({step.launches} launches"
                  + (f", {n_layers} of {cfg.n_layers} layers" if n_layers
                     else "")
                  + f"): kernel {row['ms']:.3f} ms, plain "
                  f"{row['plain_ms']:.3f} ms, library "
                  f"{row['library_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# The kernels of the three wave paths served in another form than dense
# bf16 (WAVE_PATHS), at their shapes: (row, architecture, kernel, A dtype,
# weight form).  K1 int8 at rwkv6's decode step (every 2-D product: the
# projections and lora_a, w_lora_a); K2 int8 A x int8 tiles at
# llama-vision's (every projection, the untied head); K3 bf16 A x bf16
# tiles at recurrentgemma's (every projection but the tied head); K3 f32 A
# x f32 tiles at recurrentgemma's RG-LRU gates (the fp32 policy's products
# against the bf16 sparse payload cast to f32 per call, as the reference
# casts it).
WAVE_FORM_ROWS = [
    ("rwkv6-int8", "rwkv6-1.6b", "k1", "int8", "dense"),
    ("vision-k2-int8", "llama-3.2-vision-11b", "k2", "int8", "int8"),
    ("rgemma-k3-bf16", "recurrentgemma-2b", "k3", "bf16", "magnitude"),
    ("rgemma-k3-f32", "recurrentgemma-2b", "k3", "f32", "magnitude"),
]


def phase_wave_forms(torch, timer):
    """The kernels of the wave paths served packed, sparse or under the
    int8 policy, at every GEMM shape of one full-width decode step (M = 2;
    ``_decode_gemms``) and, printed beside it, a 32-row prefill
    (``WAVE_FORM_ROWS``); llama-vision's cross K/V over the image states
    (M = 2 x 1600 rows, a prefill's 16 launches); K6 packing every
    llama-vision weight into int8.  Each case on the design the rule names,
    within its tolerance of the plain version (K6 byte for byte), timed
    beside it, the bound and one PyTorch call (``torch.matmul`` on the
    weight decoded beforehand) -> rows by label, each a decode step's (or
    a prefill's, or a load's) launches weighted."""
    from repro_torch.configs import base as cb
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_packed, mpgemm_packed_plain, mpgemm_plain,
        mpgemm_sparse, mpgemm_sparse_plain,
    )
    from repro_torch.packing.pack import pack_operand, unpack_reference
    from repro_torch.packing.params import default_blocks
    from repro_torch.sparse import densify_operand, sparsify_magnitude

    gen = torch.Generator(device="cuda").manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {}

    def case(what, kernel, a_dt, fmt, k, n, kind, act, m, extras_dt):
        """One case -> (err, ms, plain_ms, library_ms, bound_ms, bytes,
        ops, design)."""
        w = torch.randn(k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        x = torch.randn(m, k, generator=gen, device="cuda")
        ep = EpilogueSpec(kind=kind, activation=act)
        out_dt = f32 if a_dt == "f32" else bf16
        extras = () if kind == "linear" else (
            torch.randn(m, n, generator=gen, device="cuda").to(extras_dt),)
        kw = dict(extras=extras, epilogue=ep, out_dtype=out_dt)
        if kernel == "k1":
            a, sx = quantize_per_tensor(x.to(bf16))
            b, sw = quantize_per_tensor(w)
            kw["scale"] = lib_scale = sx * sw
            w_lib, x_lib = b.to(bf16), a.to(bf16)     # exact: |q| <= 127

            def kern():
                return mpgemm(a, b, spec=GemmSpec(), **kw)

            def plain():
                return mpgemm_plain(a, b, **kw)
            w_bytes, design_of = b.numel(), _k1_design_of
        elif kernel == "k2":
            a, kw["scale"] = quantize_per_tensor(x.to(bf16))
            b = pack_operand(w, default_blocks(k, n), dtype=fmt)
            # The library's weight, dequantized beforehand.
            w_lib = unpack_reference(b.payload, b.scales, b.layout,
                                     "bfloat16")
            x_lib, lib_scale = x.to(bf16), None

            def kern():
                return mpgemm_packed(a, b, **kw)

            def plain():
                return mpgemm_packed_plain(a, b, **kw)
            w_bytes, design_of = b.nbytes, _k2_design_of
        else:
            dt = f32 if a_dt == "f32" else bf16
            # As served: a bf16 payload, cast to f32 per call for f32 A.
            b = sparsify_magnitude(w, SPARSE_BLOCKS, density=0.5,
                                   dtype="bfloat16").astype(dt)
            a = x.to(dt)
            w_lib, x_lib, lib_scale = densify_operand(b, dtype=dt), a, None

            def kern():
                return mpgemm_sparse(a, b, **kw)

            def plain():
                return mpgemm_sparse_plain(a, b, **kw)
            w_bytes, design_of = b.nbytes, _k3_design_of

        def library():
            acc = torch.matmul(x_lib, w_lib)
            return apply_epilogue(ep, acc.float(), scale=lib_scale,
                                  extras=extras).to(out_dt)

        (got, design), again, ref = design_of(kern), kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two launches differ")
        err = _check_close(torch, what, got, ref, TOL[_dtype_name(out_dt)])
        esz = a.element_size()
        n_bytes = (w_bytes + m * k * esz
                   + m * n * out_dt.itemsize * (1 + len(extras)))
        n_ops = 2 * m * (b.layout.nnz * b.layout.bk * b.layout.bn
                         if kernel == "k3" else n * k)
        bound, bound_by = _bound_ms(n_bytes, n_ops, {
            "int8": "int8", "bf16": "bfloat16", "f32": "float32"}[a_dt])
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        print(f"[wave-forms] {what:>62} {design:>5}: err {err:.2e}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.4f} ({bound_by})")
        del a, b, w, x, got, again, ref, w_lib
        return err, ms, plain_ms, lib_ms, bound, n_bytes, n_ops, design

    for label, arch, kernel, a_dt, fmt in WAVE_FORM_ROWS:
        cfg = cb.get(arch)
        step = StepSum()
        for (g, k, n, kind, act, _, tb, fp32), per_step in \
                _decode_gemms(cfg, cfg.n_layers).items():
            if g > 1 or fp32 != (a_dt == "f32") or (tb and kernel != "k1"):
                continue        # grouped, another policy, the tied head
            for m in (2, 32):
                what = (f"{kernel.upper()} {label} m={m} k={k} n={n} "
                        f"{kind}/{act}")
                err, ms, plain_ms, lib_ms, bound, n_bytes, n_ops, design = \
                    case(what, kernel, a_dt, fmt, k, n, kind, act, m,
                         f32 if a_dt == "f32" else bf16)
                want = "simt" if a_dt == "f32" else "wgmma"
                if design != want:
                    raise AssertionError(f"{what}: ran {design}, want {want}")
                step.max_abs_err = max(step.max_abs_err, err)
                step.designs.append(design)
                if m == 2:
                    step.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                             n_ops)
        rows[label] = step.row({"int8": "int8", "bf16": "bfloat16",
                                "f32": "float32"}[a_dt])
        rows[label]["designs"] = step.designs
    # llama-vision's cross K/V: each cross layer's wk and wv over the image
    # states of both rows at prefill.
    cfg = cb.get("llama-3.2-vision-11b")
    kv = cfg.n_kv_heads * cfg.head_dim
    n_cross = sum(kind == "cross" for kind in cfg.pattern)
    step = StepSum()
    what = f"K2 vision cross K/V m={2 * cfg.n_image_tokens} k={cfg.d_model} " \
        f"n={kv}"
    err, ms, plain_ms, lib_ms, bound, n_bytes, n_ops, design = case(
        what, "k2", "int8", "int8", cfg.d_model, kv, "linear", None,
        2 * cfg.n_image_tokens, bf16)
    if design != "wgmma":
        raise AssertionError(f"{what}: ran {design}")
    step.max_abs_err = err
    step.add(2 * n_cross, ms, plain_ms, lib_ms, bound, n_bytes, n_ops)
    rows["vision-k2-cross-kv"] = step.row("int8")
    # K6: every llama-vision weight into int8, each distinct shape once,
    # weighted by its count in the model.
    d, f, q = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    vp = -(-cfg.vocab // 128) * 128
    load = StepSum()
    for name, shape, count in (("wq/wo", (d, q), 2 * cfg.n_layers),
                               ("wk/wv", (d, kv), 2 * cfg.n_layers),
                               ("gate/up", (d, f), 2 * cfg.n_layers),
                               ("down", (f, d), cfg.n_layers),
                               ("head", (d, vp), 1)):
        w = torch.randn(*shape, generator=gen, device="cuda") * \
            (2.0 / sum(shape)) ** 0.5
        (layout, design, ms, scalar_ms, plain_ms, bound, bound_by,
         n_bytes) = _k6_case(torch, timer, f"vision {name}", w,
                             default_blocks(*shape), False, "int8", "stream")
        print(f"[wave-forms] K6 vision {name:>7} {str(shape):>14} -> int8 "
              f"{design}: byte-equal  kernel {ms:.4f} ms  scalar kernel "
              f"{scalar_ms:.4f}  plain {plain_ms:.4f}  bound {bound:.4f} "
              f"({bound_by}), x{count}")
        load.add(count, ms, plain_ms, 0.0, bound, n_bytes, 0, scalar_ms)
        del w
    rows["vision-k6"] = dict(load.row("float32"), library_ms=None)
    for label, row in rows.items():
        print(f"[wave-forms] {label}: kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), max err "
              f"{row['max_abs_err']:.2e}")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_k7(torch, timer):
    """K7 (the tile unpacker) against its plain version, bit for bit, on
    the design ``k7_design`` picks ("stream" for every model weight) and
    on the scalar kernel (``_k7_scalar``, the "was" column): every
    full-width phi3-mini weight shape packed as int4, int8, fp8 and bf16
    (each unpacked to bf16), and granite's expert stacks; a case of its
    own ("simt-rows": rows of 3004 columns) runs the scalar kernel through
    the wrapper.  Each timed against its bytes bound (payload and scales
    read once, the dense operand written once); a bf16 payload also
    against the one PyTorch copy that computes the same function (the
    tiles' transposed view reshaped: ``library_ms``)."""
    from repro_torch.packing.pack import (
        pack_operand, unpack_operand, unpack_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    bf16 = torch.bfloat16
    shapes = [(nm, (k, n), 2 * c if nm == "up" else c, "stream")
              for nm, k, n, _, _, c in MAIN_SHAPES if nm != "gate"]
    shapes += [("g-experts-up/gate", (GRANITE_EXPERTS, 1024, 512), 0,
                "stream"),
               ("g-experts-down", (GRANITE_EXPERTS, 512, 1024), 0, "stream"),
               ("simt-rows", (1000, 3004), 0, "simt")]
    model = {fmt: StepSum() for fmt in PAYLOADS}
    rows = {}
    rule = _pack_rule("k7_design")
    for name, shape, per_model, want in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * 0.02
        for fmt in PAYLOADS:
            p = pack_operand(w, (128, 128), dtype=fmt)
            layout = p.layout

            def kern():
                return unpack_operand(p, dtype="bfloat16")

            def plain():
                return unpack_reference(p.payload, p.scales, layout,
                                        "bfloat16")

            def scalar():
                return _k7_scalar(torch, p, bf16)

            (got, design), ref, old = _stream_design_of(kern, "k7"), \
                plain(), scalar()
            torch.cuda.synchronize()
            if design != (rule(p, bf16) if rule else "simt") or (
                    rule and design != want):
                raise AssertionError(f"K7 {name} {fmt}: ran the {design} "
                                     "design")
            for what, out in ((design, got), ("scalar", old)):
                if not torch.equal(out.view(torch.int16),
                                   ref.view(torch.int16)):
                    raise AssertionError(f"K7 {name} {fmt}: the {what} "
                                         "kernel's output differs from the "
                                         "plain version")
            n_bytes = p.nbytes + got.numel() * got.element_size()
            bound, bound_by = _bound_ms(n_bytes, 0, "float32")
            ms, scalar_ms, plain_ms = timer(kern), timer(scalar), \
                timer(plain)
            lib_ms = 0.0
            whole = layout.k % layout.bk == 0 and layout.n % layout.bn == 0
            if fmt == "bfloat16" and whole:
                # One copy: the (.., nkb, bk, nnb, bn) view reshaped.
                def library():
                    return p.payload.transpose(-3, -2).reshape(got.shape)

                if not torch.equal(library().view(torch.int16),
                                   ref.view(torch.int16)):
                    raise AssertionError(f"K7 {name}: the library copy "
                                         "differs from the plain version")
                lib_ms = timer(library)
            print(f"[k7] {name:>18} {str(shape):>16} {fmt:>8} -> bf16 "
                  f"{design:>6}: bit-equal  kernel {ms:.4f} ms  scalar "
                  f"kernel {scalar_ms:.4f}  plain {plain_ms:.4f}"
                  + (f"  library (one copy) {lib_ms:.4f}" if lib_ms else "")
                  + f"  bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s ({100 * bound / ms:.0f} % "
                  f"of the bound)")
            model[fmt].add(per_model, ms, plain_ms, lib_ms, bound, n_bytes, 0,
                           scalar_ms)
            if name == "up" and fmt == "bfloat16":
                rows["up-bf16"] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib_ms, scalar_ms=scalar_ms,
                                       bound_ms=bound, bound_by=bound_by,
                                       max_abs_err=0.0)
    for fmt, acc in model.items():
        rows[fmt] = acc.row("float32")
        print(f"[k7] unpacking a full-width phi3-mini ({acc.launches} "
              f"weights) from {fmt}: kernel {acc.ms:.3f} ms, scalar kernel "
              f"{acc.scalar_ms:.3f} ms, plain {acc.plain_ms:.3f} ms, bound "
              f"{acc.bound_ms:.3f} ms")
    return rows


def phase_packed_grad(torch):
    """``mp_dot`` forward and backward on full-width phi3 ``w_up`` (3072 x
    8192) packed bf16 (trainable: K2 forward; K7, K1 trans_b and trans_a,
    K6 backward) and int4 (frozen: dx only), 512 bf16 tokens, and the
    forward of the bf16 payload under the int8 policy (K7, then int8 K1);
    each against the same calls through the plain versions (bf16 outputs:
    atol = rtol = 1.6e-2).  -> the launch counts of the phase."""
    from repro_torch.core.gemm import mp_dot
    from repro_torch.packing.pack import pack_operand

    gen = torch.Generator(device="cuda").manual_seed(10)
    k, n = 3072, 8192
    w = torch.randn(k, n, generator=gen, device="cuda") * (2 / (k + n)) ** .5
    x0 = torch.randn(TRAIN_TOKENS, k, generator=gen,
                     device="cuda").to(torch.bfloat16)
    dy = torch.randn(TRAIN_TOKENS, n, generator=gen, device="cuda")
    packed = {fmt: pack_operand(w, (128, 128), dtype=fmt)
              for fmt in ("bfloat16", "int4")}

    def run(fmt, policy):
        p = packed[fmt]
        p.payload.grad = None
        if p.layout.codec is None:
            p.payload.requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        y = mp_dot(x, p, policy=policy)
        if policy == "int8":
            return [y.detach()]
        (y.float() * dy).sum().backward()
        return [y.detach(), x.grad] + ([p.payload.grad]
                                       if p.layout.codec is None else [])

    _reset_counters()
    cases = [("bfloat16", "bf16"), ("int4", "bf16"), ("bfloat16", "int8")]
    got = [run(fmt, pol) for fmt, pol in cases]
    torch.cuda.synchronize()
    counts = _read_counters()
    with _plain_versions():
        want = [run(fmt, pol) for fmt, pol in cases]
    for (fmt, pol), gs, ws in zip(cases, got, want):
        for what, g, w_ in zip(("y", "dx", "dpayload"), gs, ws):
            err = _check_close(torch, f"packed grad {fmt}/{pol} {what}", g,
                               w_, TOL["bfloat16"])
            print(f"[packed-grad] {fmt} payload under {pol}: {what} "
                  f"{tuple(g.shape)} {_dtype_name(g.dtype)}, max |kernel - "
                  f"plain| {err:.3e} (atol = rtol = 1.6e-2)")
    # bf16/bf16: K2 fwd, K7, dx (trans_b), dW (trans_a), K6; int4/bf16: K2
    # fwd, K7, dx; bf16/int8: K7, then int8 K1.  Every K6 and K7 launch on
    # the stream design.
    want_counts = dict(k2=2, k7=3, k1=4, k1_tb=2, k1_ta=1, k6=1, k6_stream=1,
                       k7_stream=3)
    seen = {key: counts[key] for key in want_counts}
    print(f"[packed-grad] launches: {seen}")
    if seen != want_counts:
        raise AssertionError(f"packed-grad launches {seen}, want "
                             f"{want_counts}")
    return counts


# ------------------------------------------------------------ phase 8b: ops

# The paper's GEMM workloads, Table III: (id, M, N, K), DeepSeek (1-18) and
# LLaMA (19-24).  A copy of benchmarks/common.py:24-33 (PAPER_WORKLOADS),
# which this script may not import; tests/test_torch_ops.py holds the two
# equal.
TABLE_III = [
    (1, 64, 2112, 7168), (2, 64, 24576, 1536), (3, 64, 32768, 512),
    (4, 64, 7168, 16384), (5, 64, 4096, 7168), (6, 64, 7168, 2048),
    (7, 128, 2112, 7168), (8, 128, 24576, 1536), (9, 128, 32768, 512),
    (10, 128, 7168, 16384), (11, 128, 4096, 7168), (12, 128, 7168, 2048),
    (13, 4096, 2112, 7168), (14, 4096, 24576, 1536), (15, 4096, 32768, 512),
    (16, 4096, 7168, 16384), (17, 4096, 4096, 7168), (18, 4096, 7168, 2048),
    (19, 4096, 256, 4096), (20, 11008, 256, 4096), (21, 4096, 256, 11008),
    (22, 5120, 256, 5120), (23, 13824, 256, 5120), (24, 5120, 256, 13824),
]
EPILOGUE_WORKLOADS = (1, 13, 19)     # Table III ids with the epilogue cases
TRANS_WORKLOADS = (13, 19)           # ... and with the transposed cases
# phi3-mini's projections at full width (d 3072, d_ff 8192): (name, K, N).
PHI3_PROJ = [("qkvo", 3072, 3072), ("gate/up", 3072, 8192),
             ("down", 8192, 3072)]
# The quant_in backward's bound on dx and dW, a share of the gradient's max
# |g|: the sound kernels read 0.22 % (dx) and 0.24 % (dW) on an H100; a
# wrong epilogue (a row scale dropped on a few rows) moves whole rows.
QUANT_IN_BWD_TOL = 0.01
# granite-moe-1b-a400m's expert stacks: (name, K, N), 32 experts each.
GRANITE_EXPERT_PROJ = [("up/gate", 1024, 512), ("down", 512, 1024)]
OPS_ITERS = 3                        # timed launches a case (each cold)


def _ops_case(name, kern, plain, *, n_bytes, n_ops, peak, library=None,
              exact=False, tol=None, copy=None):
    """One op-level case: the kernel's call, its plain version's, a
    library yardstick or None, the bound's bytes and operations, the
    check (``exact``: equal bits, else ``tol``), and ``copy``, a call of
    the operand copy the kernel's call makes first, timed alone."""
    return dict(name=name, kern=kern, plain=plain, library=library,
                n_bytes=n_bytes, n_ops=n_ops, peak=peak, exact=exact,
                tol=tol or TOL[peak if peak != "int8" else "bfloat16"],
                copy=copy)


def _ops_row(torch, timer, label, counter, cases):
    """Drive one row's path -- each case's call once -- with every launch
    count at 0 just before and read just after: every launch must be
    ``counter``'s, one per case.  Then each case against its plain version
    (equal bits or the tolerance), and timed: kernel, plain, library.  ->
    the row's numbers (times summed over its cases, one launch each); each
    case names the design it ran."""
    _reset_counters()
    design_of = {"k1": _k1_design_of, "k1g": _k1_design_of,
                 "k2": _k2_design_of, "k2g": _k2_design_of,
                 "k3": _k3_design_of, "k3g": _k3_design_of}[counter]
    ran = [design_of(c["kern"]) for c in cases]
    torch.cuda.synchronize()
    counts = _read_counters()
    launched = {k: v for k, v in counts.items()
                if v and k in _counters()}
    if launched != {counter: len(cases)}:
        raise AssertionError(f"{label}: launches {launched}, want "
                             f"{{{counter!r}: {len(cases)}}}")
    acc = StepSum()
    library = all(c["library"] is not None for c in cases)
    copy_ms = 0.0
    # tf32x3 cases' side bounds: the f32 CUDA cores' (the scalar design's)
    # and the design's own three products a multiply-add on the tensor
    # cores.
    fma_ms = three_ms = 0.0
    for c, (got, design) in zip(cases, ran):
        ref = c["plain"]()
        torch.cuda.synchronize()
        if c["exact"]:
            if got.dtype != ref.dtype or not torch.equal(got, ref):
                bad = (got.to(torch.int64) - ref.to(torch.int64)).abs().max()
                raise AssertionError(f"{label} {c['name']}: int32 output "
                                     f"differs from the plain version (max "
                                     f"|diff| {bad.item()})")
            err = 0.0
        else:
            err = _check_close(torch, f"{label} {c['name']}", got, ref,
                               c["tol"])
        del ref
        bound, bound_by = _bound_ms(c["n_bytes"], c["n_ops"],
                                    _peak_of(design, c["peak"]))
        if design == "tf32x3":
            fma_ms += _bound_ms(c["n_bytes"], c["n_ops"], "float32")[0]
            three_ms += _bound_ms(c["n_bytes"], 3 * c["n_ops"],
                                  "tfloat32")[0]
        ms = timer(c["kern"], OPS_ITERS)
        plain_ms = timer(c["plain"], OPS_ITERS)
        lib_ms = timer(c["library"], OPS_ITERS) if library else 0.0
        case_copy = timer(c["copy"], OPS_ITERS) if c["copy"] else None
        copy_ms += case_copy or 0.0
        acc.max_abs_err = max(acc.max_abs_err, err)
        acc.add(1, ms, plain_ms, lib_ms, bound, c["n_bytes"], c["n_ops"])
        rate = c["n_ops"] / ms / 1e9
        print(f"[ops:{label}] {c['name']:>24} {design:>6}: "
              + ("equal" if c["exact"] else f"err {err:.2e}")
              + f"  kernel {ms:.4f} ms"
              + (f" (A copy {case_copy:.4f})" if case_copy else "")
              + f"  plain {plain_ms:.4f}"
              + (f"  library {lib_ms:.4f}" if library else "")
              + f"  bound {bound:.4f} ({bound_by})  {rate:.2f} TOP/s")
    designs = [design for _, design in ran]
    del ran
    row = acc.row(_peak_of(designs[0], cases[0]["peak"]))
    row["library_ms"] = row["library_ms"] if library else None
    row["launches"] = counts[counter]
    row["designs"] = designs
    if any(c["copy"] for c in cases):
        row["copy_ms"] = copy_ms
    if "tf32x3" in designs:
        row["bound_f32_fma_ms"], row["bound_3xtf32_ms"] = fma_ms, three_ms
        print(f"[ops:{label}] tf32x3 cases' side bounds: f32 FMA on the "
              f"CUDA cores {fma_ms:.3f} ms, three tf32 products a "
              f"multiply-add {three_ms:.3f} ms")
    print(f"[ops:{label}] {len(cases)} launches of {counter}: kernel "
          f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
          + (f"{row['library_ms']:.3f} ms" if library else "none")
          + f", bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return row


def _ops_plain(a, b, c=None, *, trans_a=False, trans_b=False, alpha=1.0,
               beta=0.0, bias=None, activation=None, out_dtype=None):
    """``ops.mpgemm`` through the plain versions (the same epilogue, and the
    same dispatch by ``b``'s form)."""
    from repro_torch.core.gemm_spec import EpilogueSpec
    from repro_torch.kernels.mpgemm import (
        mpgemm_packed_plain, mpgemm_plain, mpgemm_sparse_plain,
    )
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse import TileSparseOperand

    kw = dict(c=c, bias=bias, out_dtype=out_dtype, epilogue=EpilogueSpec(
        alpha=alpha, beta=beta, activation=activation))
    if isinstance(b, PackedOperand):
        return mpgemm_packed_plain(a, b, trans_a=trans_a, **kw)
    if isinstance(b, TileSparseOperand):
        return mpgemm_sparse_plain(a, b, trans_a=trans_a, **kw)
    return mpgemm_plain(a, b, trans_a=trans_a, trans_b=trans_b, **kw)


def _table3_operands(torch, gen, m, n, k, dt, trans_a=False, trans_b=False):
    """Table III operands: ints uniform in +-127, floats A ~ N(0, 1) and
    B ~ N(0, 1/K) (outputs of unit scale, as a weight's init gives)."""
    if dt == torch.int8:
        a = torch.randint(-127, 128, (k, m) if trans_a else (m, k),
                          generator=gen, device="cuda", dtype=dt)
        b = torch.randint(-127, 128, (n, k) if trans_b else (k, n),
                          generator=gen, device="cuda", dtype=dt)
        return a, b
    a = torch.randn(*((k, m) if trans_a else (m, k)), generator=gen,
                    device="cuda").to(dt)
    b = (torch.randn(*((n, k) if trans_b else (k, n)), generator=gen,
                     device="cuda") * k ** -0.5).to(dt)
    return a, b


# The design the K1 rule gives every Table III shape, by operand dtype.
TABLE_III_DESIGN = {"float32": "tf32x3", "bfloat16": "wgmma",
                    "int8": "wgmma"}


def _table3_row(torch, timer, gen, dt, check_design=True, f32_fma=False):
    """The 24 Table III shapes through ``ops.mpgemm`` at ``dt`` (f32 ->
    f32, bf16 -> bf16, int8 -> int32 equal to the plain version), one row;
    every case on :data:`TABLE_III_DESIGN`'s design unless
    ``check_design`` is off (chip_ab.py's older trees).  ``f32_fma``: the
    f32 shapes through ``mpgemm(a, b, f32_fma=True)`` instead, K1's fma
    design (the fp32 policy's arithmetic), each case first held bit for
    bit to the scalar loop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mpgemm import mpgemm

    i8 = dt == torch.int8
    label = "table3-" + {torch.float32: "f32", torch.bfloat16: "bf16",
                         torch.int8: "int8"}[dt] + ("-fma" if f32_fma
                                                    else "")
    cases = []
    for wid, m, n, k in TABLE_III:
        a, b = _table3_operands(torch, gen, m, n, k, dt)
        esz = a.element_size()
        if i8:
            library = (lambda a=a, b=b: torch._int_mm(a, b))
        else:
            library = (lambda a=a, b=b: torch.matmul(a, b))
        if f32_fma:
            kern = (lambda a=a, b=b: mpgemm(a, b, f32_fma=True))
            got, design = _k1_design_of(kern)
            if design == "fma":
                _check_fma_bits(torch, f"{label} W{wid}", got, kern(),
                                _k1_scalar(torch, a, b))
            del got
        else:
            kern = (lambda a=a, b=b: ops.mpgemm(a, b))
        cases.append(_ops_case(
            f"W{wid} {m}x{n}x{k}", kern,
            lambda a=a, b=b: _ops_plain(a, b),
            library=library, exact=i8,
            n_bytes=(m * k + k * n) * esz + m * n * (4 if i8 else esz),
            n_ops=2 * m * n * k, peak=_dtype_name(dt)))
    row = _ops_row(torch, timer, label, "k1", cases)
    want = "fma" if f32_fma else TABLE_III_DESIGN[_dtype_name(dt)]
    if check_design and set(row["designs"]) != {want}:
        raise AssertionError(f"{label}: designs {row['designs']}, want "
                             f"{want}")
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_table3_f32(torch, timer):
    """Table III in f32 alone (for chip_ab.py), on 3xTF32 (``ops.mpgemm``)
    and on the fma design (``f32_fma``; the scalar loop on a tree without
    it): -> {"table3-f32": row, "table3-f32-fma": row}."""
    rows = {}
    for key, fma in (("table3-f32", False), ("table3-f32-fma", True)):
        gen = torch.Generator(device="cuda").manual_seed(11)
        rows[key] = _table3_row(torch, timer, gen, torch.float32,
                                check_design=False, f32_fma=fma)
    return rows


def _table3_rows(torch, timer, gen):
    """The paper's GEMMs: the 24 Table III shapes through ``ops.mpgemm`` in
    f32 -> f32, bf16 -> bf16 and int8 -> int32 (equal to the plain
    version); then the epilogue cases (W1, W13, W19) and the transposed
    ones (W13, W19), one row per precision."""
    from repro_torch.kernels import ops

    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    rows = {}
    for label, dt in (("f32", f32), ("bf16", bf16), ("int8", i8)):
        rows[f"table3-{label}"] = _table3_row(torch, timer, gen, dt)

    shapes = {wid: (m, n, k) for wid, m, n, k in TABLE_III}
    cases, int_cases = {f32: [], bf16: []}, []
    for wid in EPILOGUE_WORKLOADS:
        m, n, k = shapes[wid]
        for dt in (f32, bf16, i8):
            a, b = _table3_operands(torch, gen, m, n, k, dt)
            bias = torch.randn(n, generator=gen, device="cuda")
            if dt == i8:
                bias = bias * 100
                c = torch.randint(-10 ** 6, 10 ** 6, (m, n), generator=gen,
                                  device="cuda", dtype=torch.int32)
                kw = dict(alpha=2.0, beta=3.0, bias=bias)
            else:
                c = torch.randn(m, n, generator=gen, device="cuda").to(dt)
                kw = dict(alpha=1.5, beta=2.0, bias=bias, activation="gelu")
            esz = a.element_size()
            # The yardstick: one addmm (beta * C + alpha * A B), float only.
            library = None if dt == i8 else (
                lambda a=a, b=b, c=c, kw=kw: torch.addmm(
                    c, a, b, beta=kw["beta"], alpha=kw["alpha"]))
            case = _ops_case(
                f"W{wid} {_dtype_name(dt)}",
                lambda a=a, b=b, c=c, kw=kw: ops.mpgemm(a, b, c, **kw),
                lambda a=a, b=b, c=c, kw=kw: _ops_plain(a, b, c, **kw),
                library=library, exact=dt == i8,
                n_bytes=(m * k + k * n) * esz + 4 * n
                + m * n * c.element_size() + m * n * (4 if dt == i8 else esz),
                n_ops=2 * m * n * k,
                peak={f32: "float32", bf16: "bfloat16", i8: "int8"}[dt])
            (int_cases if dt == i8 else cases[dt]).append(case)
    for dt, key in ((f32, "beta-c-f32"), (bf16, "beta-c-bf16")):
        rows[key] = _ops_row(torch, timer, key, "k1", cases[dt])
    rows["int32-epilogue"] = _ops_row(torch, timer, "int32-epilogue", "k1",
                                      int_cases)

    cases, int_cases = {f32: [], bf16: []}, []
    for wid in TRANS_WORKLOADS:
        m, n, k = shapes[wid]
        a, b = _table3_operands(torch, gen, m, n, k, i8, trans_a=True)
        int_cases.append(_ops_case(
            f"W{wid} int8 trans_a",
            lambda a=a, b=b: ops.mpgemm(a, b, trans_a=True),
            lambda a=a, b=b: _ops_plain(a, b, trans_a=True),
            library=lambda a=a, b=b: torch._int_mm(a.t(), b),
            exact=True, n_bytes=(m * k + k * n) + 4 * m * n,
            n_ops=2 * m * n * k, peak="int8"))
        for dt in (f32, bf16):
            a, b = _table3_operands(torch, gen, m, n, k, dt, trans_a=True,
                                    trans_b=True)
            esz = a.element_size()
            cases[dt].append(_ops_case(
                f"W{wid} {_dtype_name(dt)} trans_a+b",
                lambda a=a, b=b: ops.mpgemm(a, b, trans_a=True, trans_b=True),
                lambda a=a, b=b: _ops_plain(a, b, trans_a=True,
                                                  trans_b=True),
                library=lambda a=a, b=b: torch.matmul(a.t(), b.t()),
                n_bytes=(m * k + k * n + m * n) * esz, n_ops=2 * m * n * k,
                peak="float32" if dt == f32 else "bfloat16"))
    rows["int8-trans_a"] = _ops_row(torch, timer, "int8-trans_a", "k1",
                                    int_cases)
    for dt, key in ((f32, "trans_a+b-f32"), (bf16, "trans_a+b-bf16")):
        rows[key] = _ops_row(torch, timer, key, "k1", cases[dt])
    for key in ("int32-epilogue", "int8-trans_a", "beta-c-f32",
                "beta-c-bf16", "trans_a+b-f32", "trans_a+b-bf16"):
        want = {TABLE_III_DESIGN["float32" if "f32" in key else "bfloat16"]}
        if set(rows[key]["designs"]) != want:
            raise AssertionError(f"{key}: designs {rows[key]['designs']}")
    # The f32 shapes again on the fma design, from the f32 row's seed: the
    # same operands as the tf32x3 row.
    rows["table3-f32-fma"] = _table3_row(
        torch, timer, torch.Generator(device="cuda").manual_seed(11), f32,
        f32_fma=True)
    return rows


def _quant_in_rows(torch, timer, gen):
    """``mp_dot(x, w, quant_in=True, activation="silu")`` and with a
    residual at phi3-mini's full-width projections, M = 2 and 32, bf16 x,
    over a dense bf16 weight (K1), packed int8, int4 and fp8 payloads (K2,
    fp8 in the int8 x fp8 loop), a packed bf16 payload (K2, the rows
    upcast) and a tile-sparse int8 one at 0.5 by magnitude (K3), through
    :func:`_ops_row_via`.  Then one backward of the dense case
    (straight-through: K1 trans_b and trans_a) against the plain
    versions."""
    from repro_torch.core.gemm import mp_dot
    from repro_torch.packing.pack import pack_operand
    from repro_torch.packing.params import default_blocks

    bf16 = torch.bfloat16
    weights = {}
    for name, k, n in PHI3_PROJ:
        w = (torch.randn(k, n, generator=gen, device="cuda")
             * (2.0 / (k + n)) ** 0.5)
        weights[name] = {
            "dense": w.to(bf16),
            **{f"packed-{fmt}": pack_operand(w, default_blocks(k, n),
                                             dtype=fmt)
               for fmt in ("int8", "int4", "fp8e4m3", "bfloat16")},
            "sparse-int8": _sparse_weight(torch, gen, (k, n), "int8",
                                          "magnitude"),
        }
    forms = [("dense", "k1"), ("packed-int8", "k2"), ("packed-int4", "k2"),
             ("packed-fp8e4m3", "k2"), ("packed-bfloat16", "k2"),
             ("sparse-int8", "k3")]
    rows = {}
    for form, counter in forms:
        calls = []
        for name, k, n in PHI3_PROJ:
            w = weights[name][form]
            for m in (2, 32):
                x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
                r = torch.randn(m, n, generator=gen, device="cuda").to(bf16)
                calls.append((f"{name} m={m} silu", x, w,
                              dict(activation="silu")))
                calls.append((f"{name} m={m} residual", x, w,
                              dict(residual=r)))
        rows[form] = _ops_row_via(torch, timer, f"quant_in-{form}",
                                  counter, mp_dot, calls)
    _quant_in_backward(torch, gen, weights["gate/up"])
    return rows


@contextlib.contextmanager
def _handed_to_wrappers():
    """Within the block, every call ``core/gemm.py`` makes to its GEMM
    wrappers (``mpgemm``, ``mpgemm_grouped``) is made and then recorded
    as (wrapper, a, b, kwargs, output)."""
    from repro_torch.core import gemm as gemm_mod

    handed = []
    saved = gemm_mod.mpgemm, gemm_mod.mpgemm_grouped

    def recorded(fn):
        def call(a, b, **kw):
            out = fn(a, b, **kw)
            handed.append((fn, a, b, kw, out))
            return out
        return call

    gemm_mod.mpgemm, gemm_mod.mpgemm_grouped = map(recorded, saved)
    try:
        yield handed
    finally:
        gemm_mod.mpgemm, gemm_mod.mpgemm_grouped = saved


def _handed_case(torch, name, fn, a, b, kw, out):
    """An :func:`_ops_case` from one recorded wrapper call: the same call
    again, its plain version, the bound's bytes (a, the weight, the scale
    and the extras read once, the output written once) and operations
    (over the stored tiles of a sparse weight)."""
    from repro_torch.sparse import TileSparseOperand

    def nbytes(t):
        return t.numel() * t.element_size()

    reads = [a, kw.get("scale"), *kw.get("extras", ())]
    n_bytes = (sum(nbytes(t) for t in reads if t is not None)
               + (nbytes(b) if isinstance(b, torch.Tensor) else b.nbytes)
               + nbytes(out))
    m = out.shape[-2]
    n_ops = 2 * out.numel() * (a.shape[-2] if kw["spec"].trans_a
                               else a.shape[-1])
    if isinstance(b, TileSparseOperand):
        n_ops = 2 * m * b.layout.bk * b.layout.bn * b.layout.nnz
    return _ops_case(
        name, lambda: fn(a, b, **kw), lambda: _plain_gemm(a, b, **kw),
        n_bytes=n_bytes, n_ops=n_ops,
        peak="bfloat16" if a.dtype == torch.bfloat16 else "int8",
        tol=TOL["bfloat16"])


def _ops_row_via(torch, timer, label, counter, op, calls):
    """:func:`_ops_row` for rows whose path is an op-level call that
    prepares its wrapper's inputs (``mp_dot`` / ``mp_dot_grouped`` with
    ``quant_in``; ``calls`` are (name, x, w, kwargs)): those calls are
    driven once, with the launch counts at 0 just before and read just
    after, and what each hands its wrapper is recorded; their outputs are
    held against the same calls through the plain versions.  Then each
    recorded wrapper call (made again, not counted) against its plain
    version, timed: the times leave out the pre-stage."""
    _reset_counters()
    with _handed_to_wrappers() as handed:
        got = [op(x, w, policy="bf16", quant_in=True, **kw)
               for _, x, w, kw in calls]
    torch.cuda.synchronize()
    counts = _read_counters()
    launched = {k: v for k, v in counts.items() if v and k in _counters()}
    if launched != {counter: len(calls)} or len(handed) != len(calls):
        raise AssertionError(f"{label}: launches {launched}, wrapper calls "
                             f"{len(handed)}, want {{{counter!r}: "
                             f"{len(calls)}}}")
    with _plain_versions():
        want = [op(x, w, policy="bf16", quant_in=True, **kw)
                for _, x, w, kw in calls]
    for (name, _, _, _), g, ref in zip(calls, got, want):
        _check_close(torch, f"{label} {op.__name__} {name}", g, ref,
                     TOL["bfloat16"])
    del got, want
    cases = [_handed_case(torch, name, *h)
             for (name, _, _, _), h in zip(calls, handed)]
    del handed
    row = _ops_row(torch, timer, label, counter, cases)
    row["launches"] = counts[counter]
    return row


def _quant_in_backward(torch, gen, weights):
    """One straight-through backward of ``mp_dot(x, w, quant_in=True,
    activation="silu")`` over phi3's dense bf16 ``w_up`` (3072 x 8192) at
    M = 32: the int8 forward, then z, dx (K1 trans_b) and dW (K1 trans_a)
    in bf16, against the same call through the plain versions.  y within
    the bf16 tolerance; dx and dW within :data:`QUANT_IN_BWD_TOL` of the
    gradient's max |g|: the backward rounds dz = dy · silu'(z) to bf16 for
    its GEMMs, and z, recomputed by each path in its own summation order,
    moves some of those roundings by an ulp, which the 32-row and
    8192-column sums of dW and dx carry."""
    from repro_torch.core.gemm import mp_dot

    w0 = weights["dense"]
    x0 = torch.randn(32, w0.shape[0], generator=gen, device="cuda").to(
        torch.bfloat16)
    dy = torch.randn(32, w0.shape[1], generator=gen, device="cuda")

    def run():
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = mp_dot(x, w, policy="bf16", quant_in=True, activation="silu")
        (y.float() * dy).sum().backward()
        return [y.detach(), x.grad, w.grad]

    _reset_counters()
    got = run()
    torch.cuda.synchronize()
    counts = _read_counters()
    with _plain_versions():
        want = run()
    y_err = _check_close(torch, "quant_in backward y", got[0], want[0],
                         TOL["bfloat16"])
    errs = []
    for what, g, ref in zip(("dx", "dW"), got[1:], want[1:]):
        err = (g.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        errs.append(err / scale)
        if not err <= QUANT_IN_BWD_TOL * scale:
            raise AssertionError(f"quant_in backward {what}: max |kernel - "
                                 f"plain| {err:.3e} beyond "
                                 f"{QUANT_IN_BWD_TOL} x {scale:.3e}")
    seen = {key: counts[key] for key in ("k1", "k1_tb", "k1_ta")}
    print(f"[ops:quant_in-backward] against the plain versions: y max |diff| "
          f"{y_err:.3e} (atol = rtol = 1.6e-2); dx, dW max |diff| "
          f"{errs[0]:.2e}, {errs[1]:.2e} of their max |g| (bound "
          f"{QUANT_IN_BWD_TOL}); launches {seen}")
    # The int8 forward, then z (the float pre-tail GEMM), dx and dW.
    if seen != dict(k1=4, k1_tb=1, k1_ta=1):
        raise AssertionError(f"quant_in backward launches {seen}")
    return counts


def _sparse_float_rows(torch, timer, gen):
    """K3 with float A against int8 tiles: ``mp_dot`` under bf16 over an
    int8 tile-sparse weight (0.5 by magnitude) at phi3-mini's projections,
    M = 2 and 32."""
    from repro_torch.core.gemm import mp_dot
    from repro_torch.kernels.mpgemm import mpgemm_sparse_plain

    bf16 = torch.bfloat16
    cases = []
    for name, k, n in PHI3_PROJ:
        w = _sparse_weight(torch, gen, (k, n), "int8", "magnitude")
        lay = w.layout
        for m in (2, 32):
            x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
            cases.append(_ops_case(
                f"{name} m={m}",
                lambda x=x, w=w: mp_dot(x, w, policy="bf16"),
                lambda x=x, w=w: mpgemm_sparse_plain(x, w, out_dtype=bf16),
                n_bytes=2 * m * k + w.nbytes + 2 * m * n,
                n_ops=2 * m * lay.bk * lay.bn * lay.nnz, peak="bfloat16"))
    return _ops_row(torch, timer, "k3-float-x-int8", "k3", cases)


def _laid_out_operands(torch, gen, k, n):
    """phi3's ``w_up`` (k, n) packed int4 (K2) and tile-sparse bf16 at 0.5
    by magnitude (K3), and each as the dense bf16 weight a library call
    reads (dequantized, densified)."""
    from repro_torch.packing.pack import pack_operand, unpack_reference
    from repro_torch.packing.params import default_blocks
    from repro_torch.sparse import densify_operand

    w = torch.randn(k, n, generator=gen, device="cuda") * (2 / (k + n)) ** .5
    packed = pack_operand(w, default_blocks(k, n), dtype="int4")
    sparse = _sparse_weight(torch, gen, (k, n), "bfloat16", "magnitude")
    dense = {"k2": unpack_reference(packed.payload, packed.scales,
                                    packed.layout, "bfloat16"),
             "k3": densify_operand(sparse, dtype=torch.bfloat16)}
    return {"k2": packed, "k3": sparse}, dense


def _laid_out_beta_c_rows(torch, timer, gen):
    """beta·C on K2 (phi3 ``w_up`` packed int4, bf16 A) and on K3 (the
    same weight tile-sparse bf16 at 0.5), M = 2 and 32, through
    ``ops.mpgemm(a, operand, c, beta=...)``; the yardstick is one addmm
    over the weight dequantized (K2) or densified (K3) beforehand."""
    from repro_torch.kernels import ops

    bf16 = torch.bfloat16
    k, n = 3072, 8192
    operands, dense = _laid_out_operands(torch, gen, k, n)
    rows = {}
    for counter, b in operands.items():
        cases = []
        for m in (2, 32):
            a = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
            c = torch.randn(m, n, generator=gen, device="cuda").to(bf16)
            kw = dict(alpha=1.5, beta=2.0, activation="relu")
            n_ops = 2 * m * n * k
            if counter == "k3":
                n_ops = 2 * m * b.layout.bk * b.layout.bn * b.layout.nnz
            cases.append(_ops_case(
                f"w_up m={m}",
                lambda a=a, b=b, c=c, kw=kw: ops.mpgemm(a, b, c, **kw),
                lambda a=a, b=b, c=c, kw=kw: _ops_plain(a, b, c, **kw),
                library=lambda a=a, w=dense[counter], c=c: torch.addmm(
                    c, a, w, beta=2.0, alpha=1.5),
                n_bytes=2 * m * k + b.nbytes + 4 * m * n, n_ops=n_ops,
                peak="bfloat16"))
        rows[counter] = _ops_row(torch, timer, f"beta-c-{counter}", counter,
                                 cases)
    return rows


def _laid_out_trans_a_rows(torch, timer, gen):
    """``trans_a`` on K2 (phi3 ``w_up`` packed int4, bf16 A) and on K3
    (the same weight tile-sparse bf16 at 0.5), A read (K, M) with M = 2
    and 32, through ``ops.mpgemm(a, operand, trans_a=True)``: the wrapper
    copies Aᵀ to (M, K) rows, timed alone beside the call; the yardstick
    is ``torch.matmul(a.t(), w)`` over the weight dequantized (K2) or
    densified (K3) beforehand."""
    from repro_torch.kernels import ops

    k, n = 3072, 8192
    operands, dense = _laid_out_operands(torch, gen, k, n)
    rows = {}
    for counter, b in operands.items():
        cases = []
        for m in (2, 32):
            a = torch.randn(k, m, generator=gen,
                            device="cuda").to(torch.bfloat16)
            n_ops = 2 * m * n * k
            if counter == "k3":
                n_ops = 2 * m * b.layout.bk * b.layout.bn * b.layout.nnz
            cases.append(_ops_case(
                f"w_up m={m}",
                lambda a=a, b=b: ops.mpgemm(a, b, trans_a=True),
                lambda a=a, b=b: _ops_plain(a, b, trans_a=True),
                library=lambda a=a, w=dense[counter]: torch.matmul(a.t(), w),
                copy=lambda a=a: a.mT.contiguous(),
                n_bytes=2 * m * k + b.nbytes + 2 * m * n, n_ops=n_ops,
                peak="bfloat16"))
        rows[counter] = _ops_row(torch, timer, f"trans_a-{counter}", counter,
                                 cases)
    return rows


def _grouped_ops_rows(torch, timer, gen):
    """At granite-moe-1b-a400m's expert shapes (32 experts, 1024 <-> 512,
    M = 2 and 32 rows an expert): beta·C on grouped K1 (bf16, f32 C and
    output, 2·A·B + 0.5·C), ``mp_dot_grouped(..., quant_in=True,
    activation="silu")`` over a dense bf16 stack (grouped K1), a packed
    int8 one (grouped K2) and an int8 N:M 2:4 sparse one (grouped K3), and
    ``mp_einsum("gmk,gkn->gmn")`` (grouped K1)."""
    from repro_torch.core.gemm import mp_dot_grouped, mp_einsum
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm_grouped, mpgemm_plain
    from repro_torch.packing.pack import pack_operand

    g, bf16, f32 = GRANITE_EXPERTS, torch.bfloat16, torch.float32
    shapes = GRANITE_EXPERT_PROJ
    rows = {}
    cases = []
    for name, k, n in shapes:
        b = (torch.randn(g, k, n, generator=gen, device="cuda")
             * (2 / (k + n)) ** .5).to(bf16)
        for m in (2, 32):
            a = torch.randn(g, m, k, generator=gen, device="cuda").to(bf16)
            c = torch.randn(g, m, n, generator=gen, device="cuda")
            ep = EpilogueSpec(alpha=2.0, beta=0.5)
            spec = GemmSpec(grouped=True)
            cases.append(_ops_case(
                f"{name} m={m}",
                lambda a=a, b=b, c=c, ep=ep, spec=spec: mpgemm_grouped(
                    a, b, c=c, spec=spec, epilogue=ep, out_dtype=f32),
                lambda a=a, b=b, c=c, ep=ep: mpgemm_plain(
                    a, b, c=c, epilogue=ep, out_dtype=f32),
                library=lambda a=a, b=b, c=c: torch.baddbmm(
                    c, a.float(), b.float(), beta=0.5, alpha=2.0),
                n_bytes=g * (2 * m * k + 2 * k * n + 8 * m * n),
                n_ops=2 * g * m * n * k, peak="bfloat16",
                tol=TOL["float32"]))
    rows["beta-c"] = _ops_row(torch, timer, "grouped-beta-c", "k1g", cases)

    stacks = {}
    for name, k, n in shapes:
        w = torch.randn(g, k, n, generator=gen, device="cuda") * \
            (2 / (k + n)) ** .5
        stacks[name] = {
            "dense": w.to(bf16),
            "packed-int8": pack_operand(w, (128, 128), dtype="int8"),
            "sparse-int8": _sparse_weight(torch, gen, (g, k, n), "int8",
                                          "nm"),
        }
    for form, counter in (("dense", "k1g"), ("packed-int8", "k2g"),
                          ("sparse-int8", "k3g")):
        calls = []
        for name, k, n in shapes:
            for m in (2, 32):
                x = torch.randn(g, m, k, generator=gen,
                                device="cuda").to(bf16)
                calls.append((f"{name} m={m}", x, stacks[name][form],
                              dict(activation="silu")))
        rows[form] = _ops_row_via(torch, timer, f"grouped-quant_in-{form}",
                                  counter, mp_dot_grouped, calls)

    cases = []
    for name, k, n in shapes:
        b = (torch.randn(g, k, n, generator=gen, device="cuda")
             * (2 / (k + n)) ** .5).to(bf16)
        a = torch.randn(g, 32, k, generator=gen, device="cuda").to(bf16)
        cases.append(_ops_case(
            f"{name} m=32",
            lambda a=a, b=b: mp_einsum("gmk,gkn->gmn", a, b, policy="bf16"),
            lambda a=a, b=b: mpgemm_plain(a, b, out_dtype=bf16),
            library=lambda a=a, b=b: torch.bmm(a, b),
            n_bytes=2 * g * (32 * k + k * n + 32 * n),
            n_ops=2 * g * 32 * n * k, peak="bfloat16"))
    rows["einsum"] = _ops_row(torch, timer, "grouped-einsum", "k1g", cases)
    return rows


def phase_ops(torch, timer):
    """The op-level API and the kernel variants it reaches (K1 beta·C,
    int8 -> int32, int8 trans_a, trans_a + trans_b, the quant_in tails of
    K1, K2 and K3, K2 int8 x fp8, K3 float x int8, K2 and K3 beta·C),
    each row driven once with the launch counts at 0 and every case held
    against its plain version.  -> {row: numbers}."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = {}
    rows.update({f"t3/{k}": v for k, v in
                 _table3_rows(torch, timer, gen).items()})
    gc.collect()
    torch.cuda.empty_cache()
    rows.update({f"qi/{k}": v for k, v in
                 _quant_in_rows(torch, timer, gen).items()})
    rows["k3-float"] = _sparse_float_rows(torch, timer, gen)
    rows.update({f"bc/{k}": v for k, v in
                 _laid_out_beta_c_rows(torch, timer, gen).items()})
    rows.update({f"ta/{k}": v for k, v in
                 _laid_out_trans_a_rows(torch, timer, gen).items()})
    rows.update({f"g/{k}": v for k, v in
                 _grouped_ops_rows(torch, timer, gen).items()})
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# K1 launches of one layer of a training step by block kind: (forward 2-D
# GEMMs, of them under the fp32 policy whatever the model's; dX launches
# (``trans_b``), dW launches (``trans_a``), z again for a gated SwiGLU;
# forward grouped GEMMs, of them fp32, their dX, dW, z; K4 launches of a
# forward).  dense / attn_local: wq, wk, wv, wo and the MLP's 3.  moe:
# the 4 attention GEMMs and the f32 router; grouped up, gate, down.
# cross: the cross-attention's 4 (wk and wv read the image states, which
# need no gradient: no dX) and the MLP's 3.  rwkv: lora_a, wr, wk, wv, wg,
# w_lora_a, wo, ck, cv, cr; the 5-stream LoRA grouped under fp32 (its f32
# ``w_lora_b`` product is a plain ``@``).  rglru: w_y, w_x, the two f32
# gates, w_out and the MLP's 3.
_TRAIN_LAYER = {
    "dense": dict(fwd=7, f32=0, dx=7, dw=7, z=1, g=0, gf32=0, gdx=0, gdw=0,
                  gz=0, k4=1),
    "moe": dict(fwd=5, f32=1, dx=5, dw=5, z=0, g=3, gf32=0, gdx=3, gdw=3,
                gz=1, k4=1),
    "cross": dict(fwd=7, f32=0, dx=5, dw=7, z=1, g=0, gf32=0, gdx=0, gdw=0,
                  gz=0, k4=1),
    "rwkv": dict(fwd=10, f32=0, dx=10, dw=10, z=0, g=1, gf32=1, gdx=1,
                 gdw=1, gz=0, k4=0),
    "rglru": dict(fwd=8, f32=2, dx=8, dw=8, z=1, g=0, gf32=0, gdx=0, gdw=0,
                  gz=0, k4=0),
}
_TRAIN_LAYER["attn_local"] = _TRAIN_LAYER["dense"]


def _want_train_launches(cfg, remat=True, seq=128, policy="bf16"):
    """Kernel launches of one training step (forward, the rematerialised
    forward, backward), summed over the layers by kind (``_TRAIN_LAYER``):
    each forward GEMM and K4 launch twice under remat, a dX launch (K1
    ``trans_b`` for a (k, n) weight; a tied head's dx reads the (V, d)
    embedding as it is) and a dW launch (``trans_a``) for every GEMM whose
    input and weight need them, plus the recompute of z for a gated
    SwiGLU GEMM; the head GEMM a loss chunk of 512 tokens, which the loss
    always rematerialises (forward twice, dx, dW).  Attention's backward is torch ops (no K4); a
    recurrence's scan is torch ops (its per-chunk remat reruns no
    kernel).  K7 never runs: the weights are dense.  Under bf16 and int8
    the wgmma design runs every bf16 and int8 K1 launch (``k1_wgmma``,
    ``k1g_wgmma``): all but the fp32-policy products' (the MoE routers,
    the RG-LRU gates, rwkv's grouped LoRA: forward, dx, dW), which run on
    K1's f32 FMA design (``k1_fma``, ``k1g_fma``); under fp32 every K1
    launch, 2-D and grouped, runs the fma design.  K1's 3xTF32 design
    (``k1_tf32x3``) runs none (``k1_design``).  K4 runs its split design
    when a kv head's G·seq folded rows number at most 16 (``k4_design``;
    the smoke configs), else its wgmma design (``k4_wgmma``,
    ``k4_split``); under fp32 its tf32x3 design above 16 folded rows
    (``k4_tf32x3``), else its scalar kernel (none of the three); heads
    wider than ``K4_MAX_D`` (recurrentgemma's 256) the scalar kernel under
    every policy."""
    tied = cfg.tie_embeddings
    r = 2 if remat else 1
    chunks = -(-seq // 512)
    per = {key: sum(_TRAIN_LAYER[kind][key] for kind in cfg.pattern)
           for key in _TRAIN_LAYER["dense"]}
    want = dict(k2=0, k2g=0, k3=0, k3g=0, k5=0, k6=0, k7=0)
    # The head a loss chunk: forward, its remat, dx and dW.
    want["k1"] = (r * per["fwd"] + per["dx"] + per["dw"] + per["z"]
                  + 4 * chunks)
    want["k1_ta"] = per["dw"] + chunks
    want["k1_tb"] = per["dx"] + (2 if tied else 1) * chunks
    want["k1g"] = r * per["g"] + per["gdx"] + per["gdw"] + per["gz"]
    want["k1g_ta"], want["k1g_tb"] = per["gdw"], per["gdx"]
    want["k4"] = r * per["k4"]
    want["k1_tf32x3"] = want["k1g_tf32x3"] = 0
    f32_2d, f32_g = (r + 2) * per["f32"], (r + 2) * per["gf32"]
    if policy == "fp32":
        want["k1_wgmma"] = want["k1g_wgmma"] = 0
        want["k1_fma"], want["k1g_fma"] = want["k1"], want["k1g"]
    else:
        want["k1_wgmma"] = want["k1"] - f32_2d
        want["k1g_wgmma"] = want["k1g"] - f32_g
        want["k1_fma"], want["k1g_fma"] = f32_2d, f32_g
    split = cfg.n_heads // cfg.n_kv_heads * seq <= 16
    f32 = policy == "fp32"
    wide = cfg.head_dim > _k4_max_d()
    want["k4_split"] = want["k4"] if split and not f32 and not wide else 0
    want["k4_wgmma"] = 0 if split or f32 or wide else want["k4"]
    want["k4_tf32x3"] = want["k4"] if f32 and not split and not wide else 0
    return want


# Kernels against plain versions over one whole training step: the loss
# within 1e-2 of its value; the global grad norm within 5 %.  Each
# gradient leaf's max |kernel - plain| within a share of the leaf's max
# |g|.  Why: the forward rounds every GEMM output and the residual stream
# to bf16, and the two paths sum in different orders, so hidden states
# differ by a few bf16 ulps (2**-8 relative) after a few layers; a
# gradient leaf sums T = 512 token contributions each off by that much,
# so its error stays a few ulps of its largest entry (5 %), not of each
# entry.  Under int8 each GEMM input is also re-quantized per tensor, so
# an input a bf16 ulp off crosses a level (step amax / 127) now and then
# (as in the serve check): 15 %.  An MoE model's top-8 routing is not a
# kernel, but it is chaotic under that noise: a token whose 8th and 9th
# gates lie within it picks another expert in the other path (a few
# percent of the 24 x 512 choices of a granite step), and that moves
# whole token contributions in every leaf behind it.  So the plain step
# replays the kernel step's expert choices (``_shared_routing``), and
# the bounds above hold for every leaf.
TRAIN_TOL = {"bf16": dict(loss=1e-2, gnorm=0.05, leaf=0.05),
             "int8": dict(loss=2e-2, gnorm=0.1, leaf=0.15)}


@contextlib.contextmanager
def _shared_routing():
    """-> ``route(mode)``: a context in which ``blocks.moe_topk`` records
    its expert choices (mode "record") or replays the recorded ones in
    call order (mode "replay"), the weights gathered from the live
    gates so that gradients flow through them as through the sort."""
    from repro_torch.models import blocks

    inner, chosen = blocks.moe_topk, []

    def recorded(gates, k):
        topw, topi = inner(gates, k)
        chosen.append(topi)
        return topw, topi

    def replayed(gates, k):
        topi = chosen[replayed.calls]
        replayed.calls += 1
        return gates.gather(-1, topi), topi

    replayed.calls = 0

    @contextlib.contextmanager
    def route(mode):
        blocks.moe_topk = recorded if mode == "record" else replayed
        try:
            yield
        finally:
            blocks.moe_topk = inner
        if mode == "replay" and replayed.calls != len(chosen):
            raise AssertionError(f"the plain step routed {replayed.calls} "
                                 f"times, the kernel step {len(chosen)}")

    yield route


def _wgmma_dw(counts):
    """A bf16 training run's K1 ``trans_a`` launches on the wgmma design:
    all but the fp32-policy products' dW, which are one in four of their
    fma launches (forward, its remat, dX, dW)."""
    return counts["k1_ta"] - counts["k1_fma"] // 4


def _train_kernel_vs_plain(torch, model, params, batch, label):
    """One step's loss and gradients through the kernels and through the
    plain versions, from the same parameters and batch, with the same
    expert choices (``_shared_routing``) and a cross block's gates open
    at 0.7 and -0.4 (``_open_gates``: at the drawn 0 every cross-attention
    gradient is 0)."""
    from repro_torch.train.train_step import _value_and_grad

    params = _open_gates(torch, params, (0.7, -0.4))
    with _shared_routing() as route:
        with route("record"):
            lk, gk = _value_and_grad(model, params, batch)
        with route("replay"), _plain_versions():
            lp, gp = _value_and_grad(model, params, batch)
    tol = TRAIN_TOL["int8" if model.policy == "int8" else "bf16"]
    leaf_tol = tol["leaf"]
    nk = float(torch.sqrt(sum((g.double() ** 2).sum()
                              for _, g in _tree_paths(gk))))
    np_ = float(torch.sqrt(sum((g.double() ** 2).sum()
                               for _, g in _tree_paths(gp))))
    worst, bad = (0.0, ""), []
    flat_p = dict(_tree_paths(gp))
    for path, g in _tree_paths(gk):
        ref = flat_p[path]
        rel = (g - ref).abs().max().item() / max(ref.abs().max().item(),
                                                 1e-30)
        if not (rel <= leaf_tol and torch.isfinite(g).all()):
            bad.append((path, rel))
        worst = max(worst, (rel, "/".join(map(str, path))))
    lerr = abs(float(lk) - float(lp))
    gerr = abs(nk - np_) / max(np_, 1e-30)
    print(f"[train:{label}] one step, kernels vs plain versions: loss "
          f"{float(lk):.6f} vs {float(lp):.6f} (|diff| {lerr:.3e}, bound "
          f"{tol['loss']}), grad norm {nk:.6f} vs {np_:.6f} (rel "
          f"{gerr:.3e}, bound {tol['gnorm']}); per leaf max |diff| / "
          f"max |g|: worst {worst[0]:.3e} at {worst[1]} (bound {leaf_tol})")
    if lerr > tol["loss"] or gerr > tol["gnorm"] or bad:
        raise AssertionError(f"train {label}: kernels and plain versions "
                             f"differ (leaves beyond bounds: {bad[:5]})")
    return dict(loss_err=lerr, gnorm_rel=gerr, leaf_rel=worst[0])


def _tree_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _n_params(cfg):
    """Parameters of a model with rms norms, rope or no positions and a
    SwiGLU MLP (every ``TRAIN_PATHS`` model), by block kind: embedding,
    untied head, the final norm and each layer's leaves as
    ``models/blocks.py`` and ``models/recurrent.py`` draw them."""
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
    vp = -(-cfg.vocab // 128) * 128
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    mlp = 3 * d * f
    w = cfg.lru_width or d
    per = {
        "dense": attn + 2 * d + mlp,
        "moe": attn + 2 * d + d * cfg.n_experts + 3 * cfg.n_experts * d * f,
        "cross": attn + 2 * d + mlp + 2,
        # norms, mu, lora_a, lora_b, wr/wk/wv/wg/wo, w_base, w_lora_a and
        # w_lora_b, u, gn_scale, mu_c, ck and cv, cr
        "rwkv": (2 * d + 5 * d + d * 32 * 5 + 5 * 32 * d + 5 * d * d + d
                 + 2 * d * 64 + d + d + 2 * d + 2 * d * f + d * d),
        # norms, w_x and w_y, conv_w and conv_b, the gates, lambda_p,
        # w_out, the MLP
        "rglru": (2 * d + 2 * d * w + cfg.conv_width * w + w + 2 * w * w + w
                  + w * d + mlp),
    }
    per["attn_local"] = per["dense"]
    return (vp * d * (1 if cfg.tie_embeddings else 2)
            + sum(per[kind] for kind in cfg.pattern) + d)


def _ckpt_dir(need_bytes):
    """A temporary checkpoint directory with room for ``need_bytes`` and a
    quarter more: in the temp dir ($TMPDIR), else in the checkout's
    ``build/`` (which git ignores)."""
    import shutil
    import tempfile
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    for base in (tempfile.gettempdir(), str(build)):
        if shutil.disk_usage(base).free > 1.25 * need_bytes:
            return tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base)
    raise RuntimeError(f"no temp directory with {1.25 * need_bytes / 1e9:.1f}"
                       " GB free for the checkpoint")


# The training paths of phase 8, by label: phase_train's arguments.  phi3
# runs at 4 of its 32 layers under int8 to keep the script's time (every
# layer is the same, so the launch counts per layer and the shapes stay).
# granite under fp32 runs every product of its step on K1's fma design
# (the fp32 policy's f32 FMA) and attention on K4's f32 kernel, at 12 of
# its 24 layers: at all 24 the path added 120 s to the script.
TRAIN_PATHS = {
    "granite-bf16": dict(arch="granite-moe-1b-a400m", policy="bf16",
                         steps=4),
    "granite-fp32": dict(arch="granite-moe-1b-a400m", policy="fp32",
                         steps=4, n_layers=12),
    "phi3-int8-4-layers": dict(arch="phi3-mini-3.8b", policy="int8",
                               steps=4, n_layers=4),
    # The cross and recurrent kinds at full width: llama-3.2-vision-11b at
    # 5 of its 40 layers, four dense and its first cross layer (all 40
    # would need ~176 GB of f32 masters, gradients and moments; these 5
    # hold 2.14 B parameters, 34 GB with gradients and moments);
    # rwkv6-1.6b at 4 of 24 (every layer the same kind); recurrentgemma-2b
    # at 5 of 26, one (rglru, rglru, attn_local) unit and a two-layer
    # tail, as the reference splits its stack.
    "llama-vision-bf16-5-layers": dict(arch="llama-3.2-vision-11b",
                                       policy="bf16", steps=4, n_layers=5),
    "rwkv6-bf16-4-layers": dict(arch="rwkv6-1.6b", policy="bf16", steps=4,
                                n_layers=4),
    "recurrentgemma-bf16-5-layers": dict(arch="recurrentgemma-2b",
                                         policy="bf16", steps=4,
                                         n_layers=5),
}
# The path whose run is repeated once under deterministic algorithms, as a
# cross-check that the default run computes the same bits.
DETERMINISM_CHECK_PATH = "granite-bf16"


@contextlib.contextmanager
def _deterministic_algorithms(torch):
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` for the
    block, the setting before restored after it."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _train_eager(torch, model, steps, batch=4, seq=128):
    """The training CLI's run (seed 0, batch 4 x seq 128 unless given, lr
    1e-3, ``steps`` steps from a fresh state) through ``Trainer(
    cuda_graphs=False)``, the eager loop -> (trainer, params, opt)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(model, ShapeConfig("cli", seq, batch, "train"),
                      TrainerConfig(steps=steps, opt=AdamWConfig(lr=1e-3)),
                      seed=0, cuda_graphs=False)
    params, opt = trainer.run()
    return trainer, params, opt


def _run_record(trainer, params, opt, host=False):
    """A finished run as its metrics log and final state (``host``: a copy
    of the state in host memory, which later steps on the trees leave
    alone)."""
    from repro_torch.optim.adamw import tree_leaves

    def keep(leaves):
        return [t.detach().cpu() for t in leaves] if host else leaves

    return dict(log=list(trainer.metrics_log),
                params=keep(tree_leaves(params)), opt=keep(tree_leaves(opt)),
                names=["/".join(map(str, path))
                       for path, _ in _tree_paths(params)])


def _train_distance(torch, got, want):
    """How far run ``got`` is from run ``want`` (``_run_record``'s): bit
    equality of every step's loss and grad norm and of the final state;
    the largest |loss difference| of a step and relative grad-norm
    difference; the worst max |diff| / max |want| over the leaves of the
    final parameters; the RMS of the difference over the whole final state
    (parameters, m, v, step) over the RMS of ``want``'s."""
    if len(got["log"]) != len(want["log"]):
        raise AssertionError(f"{len(got['log'])} steps against "
                             f"{len(want['log'])}")
    logs = list(zip(got["log"], want["log"]))
    equal = all((a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
                for a, b in logs)
    loss = max(abs(a["loss"] - b["loss"]) for a, b in logs)
    gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                for a, b in logs)
    leaf, num, den = (0.0, 0), 0.0, 0.0
    for i, (a, b) in enumerate(zip(got["params"] + got["opt"],
                                   want["params"] + want["opt"])):
        dev = b.device if a.device.type == "cpu" else a.device
        a, b = a.detach().to(dev), b.detach().to(dev)   # a host copy: one leaf
        equal = equal and torch.equal(a, b)
        if i < len(want["params"]):
            leaf = max(leaf, ((a.float() - b.float()).abs().max().item()
                              / max(b.float().abs().max().item(), 1e-30), i))
        num += float(((a.double() - b.double()) ** 2).sum())
        den += float((b.double() ** 2).sum())
    return dict(equal=equal, loss=loss, gnorm=gnorm, leaf=leaf[0],
                leaf_at=want["names"][leaf[1]], rms=(num / den) ** 0.5)


def _fmt_distance(d):
    return (f"{'bit-equal' if d['equal'] else 'not bit-equal'} (step loss "
            f"|diff| <= {d['loss']:.3e}, grad norm rel <= {d['gnorm']:.3e}, "
            f"final params per leaf max |diff| / max |p| <= {d['leaf']:.3e} "
            f"at {d['leaf_at']}, RMS of the state's difference / RMS of "
            f"the state {d['rms']:.3e})")


def _check_same_run(label, what, d):
    """Hold ``d`` (``_train_distance`` of one run against another) to bit
    equality."""
    print(f"[train:{label}] {what}: {_fmt_distance(d)}")
    if not d["equal"]:
        raise AssertionError(f"train {label}: {what}: not bit-equal")


def _nondeterministic_ops(torch, model):
    """The backward ops of a training step that sum rows several tokens
    share, as the port runs them, each run twice on the same inputs at
    this model's training shapes (batch 4 x seq 128) -> {op: repeats bit
    for bit}: the embedding gather's (``F.embedding``, ``LM._embed``, into
    the f32 (V, d) table) and, for an MoE model, the dispatch gather's
    (``blocks.DispatchGather`` into the (b, s, d) tokens of the model's
    activation dtype, each read by up to k expert slots).  autograd through
    indexing and through ``torch.gather`` (``index_put_`` with accumulate,
    ``scatter_add``), which these replace, did not repeat themselves."""
    from repro_torch.models import blocks
    from repro_torch.models.transformer import MOE_TRAIN_CAPACITY

    cfg, dev, act = model.cfg, model.device, model.act_dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, d = 4, 128, cfg.d_model
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device=dev)
    table = torch.randn(cfg.vocab, d, generator=gen, device=dev,
                        requires_grad=True)
    dy = torch.randn(b, s, d, generator=gen, device=dev)
    cases = {"embedding gather backward (F.embedding)":
             lambda: torch.autograd.grad(torch.nn.functional.embedding(
                 tokens, table), table, dy)[0]}
    if cfg.family == "moe":
        e, k = cfg.n_experts, cfg.experts_per_token
        gates = torch.softmax(torch.randn(b, s, e, generator=gen,
                                          device=dev), dim=-1)
        _, topi = blocks.moe_topk(gates, k)
        cap = blocks.moe_capacity(MOE_TRAIN_CAPACITY, k, s, e)
        src, dest_tok = blocks.moe_dispatch(topi, e, cap)
        x = torch.randn(b, s, d, generator=gen, device=dev).to(
            act).requires_grad_(True)
        dbuf = torch.randn(b, e * cap, d, generator=gen, device=dev).to(act)
        cases[f"MoE dispatch gather backward (DispatchGather, "
              f"{_dtype_name(act)})"] = (
            lambda: torch.autograd.grad(blocks.DispatchGather.apply(
                x, src, dest_tok, k), x, dbuf)[0])
    return {name: torch.equal(fn(), fn()) for name, fn in cases.items()}


def phase_train(torch, *, label, arch, policy, steps, n_layers=None):
    """Train through ``repro_torch.launch.train.main``: ``steps`` steps of
    batch 4 x seq 128 with remat, the step captured in a CUDA graph after
    the first (the CLI's default), a checkpoint after the last step:
    finite loss and grad norm, exact launch counts of every step (a replay
    counts its graph's launches).  The run's final state is kept on the
    host; then one eager step (timed untraced too) and one replayed step
    of that run traced with ``torch.profiler``, and the backward ops that
    sum rows several tokens share, each twice (``_nondeterministic_ops``:
    every one must repeat itself).  Then, with the captured run's state
    and graph freed (the card holds one full-width run at a time),
    ``--resume`` (which restores the checkpoint and has no step left to
    run): restored parameters and AdamW state bit-equal to the run's; the
    same run on the eager loop (``Trainer(cuda_graphs=False)``) with the
    same counts, its step metrics and final state bit-equal to the
    captured run's (where they differ, a second eager run tells whether
    the eager loop repeats itself: an error either way); on
    ``DETERMINISM_CHECK_PATH`` the captured run once more under
    deterministic algorithms, bit-equal to the default one; a run stopped
    after its first step with a checkpoint and resumed (captured) to
    ``steps``, bit-equal to the uninterrupted captured run; from that run's
    state, one step through the kernels against the same step through the
    plain versions (``_train_kernel_vs_plain``)."""
    import dataclasses
    import shutil

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import SyntheticLM, device_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import tree_leaves

    cfg = cb.get(arch)
    if n_layers is not None:      # the training CLI's --layers cut
        # (``launch/train.py::cut_layers``), written out so that
        # ``chip_ab.py`` can run this phase on trees that predate it
        cfg = dataclasses.replace(cfg, n_layers=n_layers,
                                  block_pattern=cfg.block_pattern[:n_layers])
    argv = ["--arch", arch, "--policy", policy, "--batch", "4", "--seq",
            "128", "--seed", "0"]
    if n_layers is not None:
        argv += ["--layers", str(n_layers)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_counters()
    ckpt = None
    try:
        # A checkpoint holds f32 params and both moments: 12 bytes each.
        ckpt = _ckpt_dir(12 * _n_params(cfg))
        print(f"[train:{label}] checkpoints in {ckpt}")
        t0 = time.perf_counter()
        trainer, params, opt = train_cli.main(
            argv + ["--steps", str(steps), "--ckpt", ckpt, "--ckpt-every",
                    str(steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counters()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        model = trainer.model
        want = {key: v * steps for key, v in _want_train_launches(
            model.cfg, policy=policy).items()
            if key in counts}    # a tree without the fma design: no k1_fma
        log = trainer.metrics_log
        graph = trainer.graph
        pool_mb = trainer.graph_pool_bytes() / 2**20
        n_params = sum(p.numel() for p in tree_leaves(params))
        times = [r["time_s"] for r in log]
        step_ms = 1e3 * float(np.median(times[1:]))
        print(f"[train:{label}] {model.cfg.name}, {model.cfg.n_layers} "
              f"layers, {n_params / 1e9:.3f} B f32 params, policy {policy}, "
              f"remat, batch 4 x seq 128, captured: {steps} steps in "
              f"{wall:.2f} s (checkpoint included); losses "
              f"{[round(r['loss'], 5) for r in log]}, grad norms "
              f"{[round(r['grad_norm'], 5) for r in log]}, step times (ms) "
              f"{[round(1e3 * t, 2) for t in times]}; median of steps 2.. "
              f"(replays) {step_ms:.2f} ms = "
              f"{TRAIN_TOKENS / step_ms * 1e3:.1f} tokens/s; peak "
              f"{peak:.2f} GB allocated")
        print(f"[train:{label}] CUDA graphs: "
              f"{0 if graph is None else 1} captured, "
              f"{0 if graph is None else graph.replays} replays, "
              f"{0.0 if graph is None else graph.capture_s:.3f} s "
              f"capturing, pool {pool_mb:.2f} MB")
        print(f"[train:{label}] launches over {steps} steps: {counts}")
        if not all(np.isfinite(r["loss"]) and r["loss"] > 0
                   and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                   for r in log) or len(log) != steps:
            raise AssertionError(f"train {label}: bad metrics {log}")
        if graph is None or graph.replays != steps - 1:
            raise AssertionError(f"train {label}: want one capture and "
                                 f"{steps - 1} replays")
        if counts != {**{k: 0 for k in counts}, **want}:
            raise AssertionError(f"train {label}: launch counts {counts}, "
                                 f"want {want}")
        print(f"[train:{label}] wgmma design: K1 {counts['k1_wgmma']} of "
              f"{counts['k1']} launches, grouped K1 {counts['k1g_wgmma']} "
              f"of {counts['k1g']} (every bf16 and int8 one); fma design: K1 "
              f"{counts.get('k1_fma')}, grouped K1 {counts.get('k1g_fma')} "
              f"(every f32 one)")
        _check_k4_designs(f"train:{label}", counts, simt=want["k4"] - sum(
            want.get(f"k4_{d}", 0) for d in ("wgmma", "split", "tf32x3")))

        # The captured run's final state, kept on the host: the card holds
        # one run's state, gradients and graph pool at a time (llama-vision
        # at 5 layers: 25.7 GB of masters and moments, a 16.6 GB pool).
        captured = _run_record(trainer, params, opt, host=True)

        # (c) one eager and one replayed step, timed and traced before this
        # process captures another graph: a replay traced after other
        # graphs were captured and destroyed once died on the card in the
        # traced ``cudaGraphLaunch`` (a segmentation fault), where the same
        # replay untraced, just before, had run.  ``phase_trace_replay``
        # rebuilds that order (``chip_ab.py . . phase_trace_replay``); it
        # has not faulted since (ROADMAP C), so the cause is not known and
        # the order stays.  Both steps move the captured run's state on,
        # after its record was taken.
        batch = device_batch(SyntheticLM(model.cfg.vocab, 4, 128, seed=7,
                                         extra_specs=trainer.pipeline
                                         .extra_specs).next_batch(), "cuda")

        def step():
            trainer.step_fn(params, opt, batch)
            torch.cuda.synchronize()

        def replay():
            graph.replay()
            torch.cuda.synchronize()

        step()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        eager_step_ms = 1e3 * float(np.median(times))
        traced = {}
        for key, what, fn, tag, ms in (
                ("eager_", "eager", step, label, eager_step_ms),
                ("", "replayed", replay, f"{label}+graph", step_ms)):
            busy, idle = _profile_decode_step(
                torch, fn, f"train:{tag}", ms,
                what=f"one {what} training step")
            traced.update({f"{key}busy_ms": busy, f"{key}idle": idle})

        ops = _nondeterministic_ops(torch, model)
        print(f"[train:{label}] backward ops that repeat bit for bit at "
              f"this path's shapes: {ops}")
        if not all(ops.values()):
            raise AssertionError(f"train {label}: backward ops that do not "
                                 f"repeat themselves: "
                                 f"{[op for op, ok in ops.items() if not ok]}")
        capture_s = graph.capture_s
        del trainer, graph, params, opt, step, replay
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _, p_res, o_res = train_cli.main(
            argv + ["--steps", str(steps), "--ckpt", ckpt, "--resume"])
        t_res = time.perf_counter() - t0
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves(p_res) + tree_leaves(o_res),
            captured["params"] + captured["opt"]))
        print(f"[train:{label}] --resume restored step {steps} in "
              f"{t_res:.2f} s: params and AdamW state (m, v, step) "
              f"bit-identical: {same}")
        if not same or int(o_res.step) != steps:
            raise AssertionError(f"train {label}: the restored state differs")
        del p_res, o_res
        gc.collect()
        torch.cuda.empty_cache()

        # (a) the same run on the eager loop.
        _reset_counters()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eager = _run_record(*_train_eager(torch, model, steps))
        torch.cuda.synchronize()
        eager_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        eager_counts = _read_counters()
        eager_ms = 1e3 * float(np.median([r["time_s"]
                                          for r in eager["log"][1:]]))
        print(f"[train:{label}] eager loop (cuda_graphs=False): losses "
              f"{[round(r['loss'], 5) for r in eager['log']]}, step times "
              f"(ms) {[round(1e3 * r['time_s'], 2) for r in eager['log']]};"
              f" median of steps 2.. {eager_ms:.2f} ms = "
              f"{TRAIN_TOKENS / eager_ms * 1e3:.1f} tokens/s; peak "
              f"{eager_peak:.2f} GB allocated")
        if eager_counts != counts:
            raise AssertionError(f"train {label}: eager launch counts "
                                 f"{eager_counts}, captured {counts}")
        d_eager = _train_distance(torch, captured, eager)
        if not d_eager["equal"]:
            # A capture that computes something else, or an eager loop
            # that does not repeat itself: a second eager run tells.
            again = _train_distance(
                torch, _run_record(*_train_eager(torch, model, steps)), eager)
            print(f"[train:{label}] the eager loop against itself: "
                  f"{_fmt_distance(again)}")
            if not again["equal"]:
                raise AssertionError(f"train {label}: the eager loop does "
                                     f"not repeat itself")
        _check_same_run(label, "captured run vs eager run", d_eager)
        del eager
        gc.collect()
        torch.cuda.empty_cache()
        det = None
        if label == DETERMINISM_CHECK_PATH:
            # Once, as a cross-check: under deterministic algorithms the
            # captured run computes the default run's bits, at its cost.
            with _deterministic_algorithms(torch):
                _reset_counters()
                tr_det, p_det, o_det = train_cli.main(
                    argv + ["--steps", str(steps)])
                det = _train_distance(torch, _run_record(tr_det, p_det,
                                                         o_det), captured)
                det_ms = 1e3 * float(np.median([
                    r["time_s"] for r in tr_det.metrics_log[1:]]))
            del tr_det, p_det, o_det
            gc.collect()
            torch.cuda.empty_cache()
            _check_same_run(label, f"captured under deterministic algorithms "
                            f"(median step {det_ms:.2f} ms, default "
                            f"{step_ms:.2f} ms) vs the default captured run",
                            det)

        # (b) a resume in the middle of a captured run.
        shutil.rmtree(ckpt)
        Path(ckpt).mkdir()
        train_cli.main(argv + ["--steps", "1", "--ckpt", ckpt,
                               "--ckpt-every", "1"])
        gc.collect()
        torch.cuda.empty_cache()
        tr_mid, p_mid, o_mid = train_cli.main(
            argv + ["--steps", str(steps), "--ckpt", ckpt, "--resume"])
        mid = _run_record(tr_mid, p_mid, o_mid)
        if tr_mid.graph is None or tr_mid.graph.replays != steps - 2:
            raise AssertionError(f"train {label}: the resumed run did not "
                                 f"replay its steps")
        tail = dict(captured, log=captured["log"][1:])
        d_mid = _train_distance(torch, mid, tail)
        _check_same_run(label, f"resumed after step 1 (captured, "
                        f"{tr_mid.graph.replays} replays) vs the "
                        f"uninterrupted captured run", d_mid)
        del tr_mid, o_mid, mid, tail, captured
        gc.collect()
        torch.cuda.empty_cache()

        # The kernels against the plain versions, from the trained state.
        errs = _train_kernel_vs_plain(torch, model, p_mid, batch, label)
    finally:
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    return dict(counts=counts, step_ms=step_ms, wall_s=wall, peak_gb=peak,
                tokens_per_s=TRAIN_TOKENS / step_ms * 1e3,
                eager_step_ms=eager_ms, eager_peak_gb=eager_peak,
                eager_tokens_per_s=TRAIN_TOKENS / eager_ms * 1e3,
                pool_mb=pool_mb, capture_s=capture_s,
                bit_equal=d_eager["equal"], repeating_ops=ops,
                deterministic=det, resumed=d_mid,
                **traced, **errs)


# The traced-replay fault: a traced replay of granite's training graph
# once died of a segmentation fault in ``cudaGraphLaunch`` after other
# graphs had been captured and destroyed (phase_train's order then: the
# serve phases traced first, the captured run, a run under deterministic
# algorithms and a resumed run each captured and destroyed, then the
# trace).  phase_trace_replay rebuilds that order; not in the default
# run: ``python3 chip_ab.py . . phase_trace_replay`` runs it alone.
# ------------------------------------------------------------------ phase 8b

# phase_plans' sweep: the tile rows within 2 steps of the rule's and the
# 4 split-ladder counts either side of its split (up to 18 candidates).
PLAN_RADIUS = 2


def _plan_cases(torch):
    """``phase_plans``' tuned shapes, where ``PERF.md`` §6 has K1 behind
    the library: (group, name, G, M, N, K, dtype, trans_a, epilogue kind,
    activation, out dtype, f32_fma, launches a step) -- phi3-mini's
    projections at M = 32 (``MAIN_SHAPES``), granite's 2-D training dW at
    512 tokens (``TRANS_A_CASES``; the router's on the fma design) and
    mixtral's grouped experts at a decode step (M = 2 rows an expert,
    ``_decode_gemms``, 8 layers)."""
    from repro_torch.configs import base as cb
    cases = [("phi3-m32", name, 1, 32, n, k, "bfloat16", False, kind, act,
              "bfloat16", False, per_step)
             for name, k, n, kind, act, per_step in MAIN_SHAPES]
    cases += [("granite-dW", name, 1, m, n, TRAIN_TOKENS, dt, True,
               "linear", None, "float32", dt == "float32", per_step)
              for name, model, m, n, dt, per_step, g in TRANS_A_CASES
              if model == "granite" and g is None]
    cases += [("mixtral-experts", f"{kind}/{act}-{k}x{n}", g, 2, n, k,
               "bfloat16", False, kind, act, "float32", False, per_step)
              for (g, k, n, kind, act, bias, tb, f32), per_step in
              _decode_gemms(cb.get("mixtral-8x22b"), MIXTRAL_LAYERS).items()
              if g > 1]
    return cases


def _check_analytic_plans(torch):
    """Every plan the launches so far resolved (the kernel layer's memo,
    ``kernels/mpgemm.py::_plans``; the simt kernels take none) against the
    design rules -> counts of checked launch shapes by kernel and
    design."""
    from repro_torch.kernels import mpgemm as K
    counts = collections.Counter()
    for key, (plan, result) in list(K._plans.items()):
        design, dev, m, n, k, g, a_dtype = key[:7]
        lay, max_count = key[-3], key[-1]
        sms = K.device_spec(dev).sms
        kernel = {"": "K1", "packed": "K2", "sparse": "K3"}[lay]
        if result != "hit_analytic":
            raise AssertionError(f"{kernel} {plan.describe()}: resolved as "
                                 f"{result} before any tuning")
        if design == "wgmma" and kernel == "K1":
            want = ((K.k1_wgmma_bm(m),)
                    + K.k1_split(m, n, k, g, sms, K.k1_wgmma_bk(a_dtype)))
        elif design == "wgmma" and kernel == "K2":
            want = (K.k1_wgmma_bm(m),) + K.k2_split(m, n, k, g, sms)
        elif design == "wgmma":
            want = (K.k1_wgmma_bm(m),) + K.k3_split(m, n, max_count, g, sms)
        elif design == "tf32x3":
            splits, per = K.k2_split(m, n, k, g, sms)
            want = (K.k1_wgmma_bm(m), splits, per * 4)
        got = (plan.bm, plan.splits, plan.per)
        if design == "fma":
            want, got = K.k1_fma_tile(m, n, k, g, sms), (plan.bm, plan.bn)
        if got != want:
            raise AssertionError(f"{kernel} {plan.describe()}: analytic "
                                 f"{got}, the design rules {want}")
        counts[(kernel, design)] += 1
    return counts


def _resolve_us(torch):
    """Host microseconds of a launch's plan resolution: a repeated launch
    (the memo) and a first one (cache lookup and analytic solve), with
    the rule calls the memo replaced beside them."""
    from repro_torch.core.gemm_spec import LINEAR
    from repro_torch.kernels import mpgemm as K
    bf16 = torch.bfloat16
    a = torch.empty(32, 3072, dtype=bf16, device="cuda")

    def resolve(m):
        return K._resolve_plan(None, "wgmma", a, bf16, m, 3072, 3072, 1,
                               False, False, bf16, LINEAR)

    resolve(32)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        resolve(32)
    memo_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        K.k1_wgmma_bm(32)
        K.k1_split(32, 3072, 3072, 1, K.H100_SMS, K.k1_wgmma_bk(bf16))
    rules_us = (time.perf_counter() - t0) / n * 1e6
    fresh = range(100_001, 100_201)
    t0 = time.perf_counter()
    for m in fresh:
        resolve(m)
    first_us = (time.perf_counter() - t0) / len(fresh) * 1e6
    return memo_us, rules_us, first_us


def phase_plans(torch):
    """The block planner on the card (module docstring, 8b).  Runs after
    every other phase: its tuning writes a plan cache the earlier phases
    must not see (they run with the empty in-memory default).  -> rows by
    group: the tuned and analytic plans' step sums."""
    import dataclasses
    import os
    import tempfile
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels import mpgemm as K
    from repro_torch.tuning import microbench as mb
    from repro_torch.tuning import plan_cache as pc

    t_phase = time.perf_counter()
    checked = _check_analytic_plans(torch)
    print(f"[plans] analytic plan = the design rules at "
          f"{sum(checked.values())} launch shapes of this run ("
          + ", ".join(f"{k} {d} {n}" for (k, d), n in sorted(checked.items()))
          + f"); lookups so far {pc.lookup_counts()}")
    memo_us, rules_us, first_us = _resolve_us(torch)
    print(f"[plans] host us a launch spends on its plan: {memo_us:.3f} "
          f"(memo hit; the rule calls it replaced: {rules_us:.3f}), a "
          f"first launch of a shape {first_us:.1f} (lookup + analytic "
          f"solve)")
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(33)
    env_before = os.environ.get(pc.ENV)
    rows = collections.defaultdict(lambda: collections.defaultdict(float))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        os.environ[pc.ENV] = path
        pc.reset_plan_cache()
        try:
            cases = _plan_cases(torch)
            for (group, name, g, m, n, k, dt, ta, kind, act, out_dt, fma,
                 per_step) in cases:
                ep = EpilogueSpec(kind=kind, activation=act)
                tune_kw = dict(out_dtype=out_dt, trans_a=ta, mode="cuda",
                               epilogue=None if kind == "linear" else ep,
                               f32_fma=fma, seed=33, radius=PLAN_RADIUS)
                res = (mb.tune_grouped_gemm(g, m, n, k, dt, **tune_kw)
                       if g > 1 else mb.tune_gemm(m, n, k, dt, **tune_kw))
                dtype, out = getattr(torch, dt), getattr(torch, out_dt)
                lead = (g,) if g > 1 else ()
                a = torch.randn(*lead, *((k, m) if ta else (m, k)),
                                generator=gen, device="cuda").to(dtype)
                w = (torch.randn(*lead, k, n, generator=gen, device="cuda")
                     * (2.0 / (k + n)) ** 0.5).to(dtype)
                extras = () if kind == "linear" else (torch.randn(
                    *lead, m, n, generator=gen, device="cuda").to(out),)
                spec = GemmSpec(grouped=g > 1, trans_a=ta)
                fn = K.mpgemm_grouped if g > 1 else K.mpgemm
                kw = dict(extras=extras, epilogue=ep, out_dtype=out,
                          f32_fma=fma)

                def kern(plan=None):
                    return fn(a, w, spec=spec, plan=plan, **kw)

                def plain():
                    return K.mpgemm_plain(a, w, trans_a=ta, extras=extras,
                                          epilogue=ep, out_dtype=out)

                def library():
                    acc = torch.matmul(a.transpose(-1, -2) if ta else a, w)
                    return apply_epilogue(ep, acc.float(),
                                          extras=extras).to(out)

                hits = pc.lookup_counts()["hit_tuned"]
                got = kern()
                if pc.lookup_counts()["hit_tuned"] != hits + 1:
                    raise AssertionError(f"[plans] {group} {name}: the "
                                         "launch did not read the tuned plan")
                torch.cuda.synchronize()
                err = _check_close(torch, f"tuned {group} {name}", got,
                                   plain(), TOL[out_dt])
                best, ana = res.best.plan, res.analytic.plan
                tuned_ms, ana_ms = timer(kern), timer(lambda: kern(ana))
                lib_ms = timer(library)
                n_bytes = g * (m * k * a.element_size()
                               + k * n * w.element_size()
                               + m * n * out.itemsize * (1 + len(extras)))
                n_ops = 2 * g * m * n * k
                bound, bound_by = _bound_ms(n_bytes, n_ops,
                                            _peak_of(best.design, dt))
                cands = "; ".join(
                    f"{_plan_tag(x.plan)} {x.wall_us / 1e3:.4f}"
                    for x in res.measurements)
                print(f"[plans] {group} {name} G={g} M={m} N={n} K={k} "
                      f"{dt}{' trans_a' if ta else ''} {best.design}: "
                      f"candidates (ms, best of 5 cold) {cands}")
                print(f"[plans] {group} {name}: winner {_plan_tag(best)}"
                      f"{'' if res.tuned_differs else ' (= analytic)'} "
                      f"{tuned_ms:.4f} ms, analytic {_plan_tag(ana)} "
                      f"{ana_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({bound_by}); tuned vs plain "
                      f"{err:.2e} (rtol {TOL[out_dt]['rtol']}) x{per_step}")
                for key, v in (("tuned_ms", tuned_ms), ("analytic_ms", ana_ms),
                               ("library_ms", lib_ms), ("bound_ms", bound)):
                    rows[group][key] += per_step * v
                rows[group]["launches"] += per_step
                rows[group]["moved"] += int(res.tuned_differs)
                rows[group]["shapes"] += 1
            # A tuned plan survives in the file; one outside the kernel's
            # limits raises at launch, whether cached or given (the last
            # case's ``kern`` and ``res``).
            disk = pc.PlanCache(path).get(res.key)
            if disk != res.best.plan:
                raise AssertionError(f"[plans] {res.key}: the file holds "
                                     f"{disk}, the tuner chose "
                                     f"{res.best.plan}")
            best = res.best.plan
            total = best.splits * best.per
            bad = {"bm 96": dataclasses.replace(best, bm=96),
                   "an empty slice": dataclasses.replace(
                       best, splits=total + 1, per=1)}
            for why, plan in bad.items():
                for how in ("cached", "given"):
                    if how == "cached":
                        pc.get_plan_cache().put(res.key, plan)
                    try:
                        kern(None if how == "cached" else plan)
                    except ValueError as e:
                        if "outside the kernel's limits" not in str(e):
                            raise
                    else:
                        raise AssertionError(f"[plans] a {how} plan with "
                                             f"{why} launched")
            pc.get_plan_cache().put(res.key, best)
            print(f"[plans] a cached or given plan with {' / '.join(bad)} "
                  f"raises at launch; the file kept the tuned plan; "
                  f"lookups {pc.lookup_counts()}")
        finally:
            if env_before is None:
                os.environ.pop(pc.ENV, None)
            else:
                os.environ[pc.ENV] = env_before
            pc.reset_plan_cache()
    for group, r in rows.items():
        print(f"[plans] {group} ({int(r['shapes'])} shapes, "
              f"{int(r['launches'])} launches a step, the plan moved on "
              f"{int(r['moved'])}): tuned {r['tuned_ms']:.3f} ms, analytic "
              f"{r['analytic_ms']:.3f} ms, library {r['library_ms']:.3f} ms, "
              f"bound {r['bound_ms']:.3f} ms")
    print(f"[time] plans phase: {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _plan_tag(plan):
    """A plan's decisions in a few characters: blocks and the split."""
    return (f"{plan.bm}x{plan.bn}x{plan.bk} s{plan.splits}x{plan.per}")


# ----------------------------------------------------------------- phase 8c

def _static_bytes(tree):
    """Bytes of every tensor of a parameter tree (int8 ``q`` and f32
    ``scale`` of static int8 weights included)."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if hasattr(t, "element_size"))


def _dequantized(torch, tree):
    """The dense twin of a static int8 tree: every ``{"q", "scale"}`` dict
    as ``dequantize_tensor(., bf16)``, every other leaf shared."""
    from repro_torch.core.quantization import dequantize_tensor, is_quantized
    if is_quantized(tree):
        return dequantize_tensor(tree, torch.bfloat16)
    if isinstance(tree, dict):
        return {k: _dequantized(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dequantized(torch, v) for v in tree]
    return tree


def _serve_requests(torch, model, params, label):
    """phase_serve's four requests through a fresh captured continuous
    engine, the counts set to 0 just before and read just after -> (tokens,
    engine, launch counts)."""
    from repro_torch.serve.engine import Request, ServeEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, model.cfg.vocab, (int(rng.integers(4, 33)),))
               .astype(np.int32) for _ in range(4)]
    eng = ServeEngine(model, params, max_len=64, max_batch=2, page_size=16)
    finite = _finite_samples(torch, eng)
    _reset_counters()
    out = eng.generate([Request(uid=i, prompt=p, max_new_tokens=16)
                        for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    counts = _read_counters()
    if (sorted(out) != [0, 1, 2, 3] or not all(out.values())
            or not all(finite) or not eng.graphs):
        raise AssertionError(f"{label}: served {sorted(out)}, finite "
                             f"{finite}, graphs {len(eng.graphs)}")
    return out, eng, counts


def _check_serve_counts(label, cfg, counts, n_steps, pack=False,
                        sparse=False):
    """A served run's counts against ``_want_launches`` (no K6: loaded
    before the counts were set to 0), every bf16 / int8 K1, K2, K3 launch
    on its wgmma design (the f32 MoE routers on the fma design) and every
    K5 launch on its split or wgmma design."""
    want, per_step = _want_launches(cfg, pack, n_steps, sparse=sparse)
    want["k6"] = 0
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, want {want}")
    routers = cfg.n_layers if cfg.family == "moe" else 0
    _check_wgmma(label, {
        "k1": counts["k1_wgmma"], "k1g": counts["k1g_wgmma"],
        "k2": counts["k2_wgmma"], "k2g": counts["k2g_wgmma"],
        "k3": counts["k3_wgmma"], "k3g": counts["k3g_wgmma"],
        "k5": counts["k5_wgmma"] + counts["k5_split"]}, dict(
        k1=(per_step["k1"] - routers) * n_steps, k1g=want["k1g"],
        k2=want["k2"], k2g=want["k2g"], k3=want["k3"], k3g=want["k3g"],
        k5=want["k5"]))
    if counts["k1_fma"] != routers * n_steps:
        raise AssertionError(f"{label}: {counts['k1_fma']} K1 launches on "
                             f"the fma design, want {routers * n_steps}")


# Static int8 storage (``core.quantization.quantize_params`` over the bf16
# weights), served at full width and depth under the bf16 policy.
STATIC_INT8_PATHS = {
    "phi3-static-int8": dict(arch="phi3-mini-3.8b"),
    "granite-static-int8": dict(arch="granite-moe-1b-a400m"),
}


def phase_static_int8(torch, *, label, arch):
    """Serve 4 requests from static int8 weights (``quantize_params`` over
    the bf16 weights ``LM.init`` gives, one scale per layer group as the
    reference's stacked leaves have; ``mp_dot`` dequantizes each weight to
    bf16 before K1) and from their dense twin (the same dequantized values
    stored bf16), each on the captured continuous engine: exact launch
    counts, every K1 launch on the wgmma design but the f32 routers', the
    same tokens; one replayed two-row decode step's logits bit-equal
    between the two; weight bytes, the median captured decode step of both,
    and a replayed step of each timed and traced, the dequantize's share
    read off their difference."""
    from repro_torch.configs import base as cb
    from repro_torch.core.quantization import quantize_params
    from repro_torch.models.transformer import build_model

    tag = f"static-int8:{label}"
    model = build_model(cb.get(arch), policy="bf16", device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    dense_gb = _static_bytes(params) / 1e9
    t0 = time.perf_counter()
    static = model.load_params(quantize_params(params, cfg=model.cfg))
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    del params
    twin = _dequantized(torch, static)
    gc.collect()
    torch.cuda.empty_cache()
    static_gb = _static_bytes(static) / 1e9
    print(f"[{tag}] {model.cfg.name}, {model.cfg.n_layers} layers, bf16 "
          f"policy: static int8 weights {static_gb:.3f} GB (bf16 weights "
          f"{dense_gb:.3f} GB), quantize_params {t_quant:.3f} s")
    runs = {}
    for what, p in (("static int8", static), ("dense twin", twin)):
        out, eng, counts = _serve_requests(torch, model, p, tag)
        n_steps = len(eng.step_telemetry)
        _check_serve_counts(f"{tag}:{what}", model.cfg, counts, n_steps)
        decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
        runs[what] = dict(out=out, decode_ms=1e3 * float(np.median(decode)))
        print(f"[{tag}] {what}: {n_steps} steps, median captured decode "
              f"step {runs[what]['decode_ms']:.2f} ms; launches K1 "
              f"{counts['k1']} (wgmma {counts['k1_wgmma']}, fma "
              f"{counts['k1_fma']}), grouped K1 {counts['k1g']}, K5 "
              f"{counts['k5']}; tokens sha1 "
              f"{_sha1(*(np.asarray(out[u]) for u in sorted(out)))}")
        del eng
    if runs["static int8"]["out"] != runs["dense twin"]["out"]:
        raise AssertionError(f"{tag}: the static int8 tokens differ from "
                             f"the dense twin's")
    steps, logits = {}, {}
    for what, p in (("static int8", static), ("dense twin", twin)):
        replay = _captured_step(torch, model, p, _decode_args(torch, model))
        logits[what] = replay().clone()
        steps[what] = replay
    torch.cuda.synchronize()
    if not torch.equal(logits["static int8"], logits["dense twin"]):
        diff = (logits["static int8"].float()
                - logits["dense twin"].float()).abs().max().item()
        raise AssertionError(f"{tag}: replayed logits differ from the "
                             f"dense twin's by {diff}")
    print(f"[{tag}] one replayed two-row decode step: logits bit-equal to "
          f"the dense twin's; served tokens identical")
    timed = {}
    for what, replay in steps.items():
        _, done = _decode_step_times(torch, replay)
        kinds = {}
        busy, idle = _profile_decode_step(
            torch, replay, f"{tag}:{what}", done,
            what=f"one replayed two-row decode step ({what})",
            kinds_out=kinds)
        timed[what] = dict(done=done, busy=busy, kinds=kinds)
    s, d = timed["static int8"], timed["dense twin"]
    torch_ms = {w: t["kinds"].get("torch", (0, 0.0)) for w, t in timed.items()}
    extra = s["done"] - d["done"]
    print(f"[{tag}] the dequantize in a replayed step: {extra:.3f} ms of "
          f"{s['done']:.3f} (share {extra / s['done']:.3f}; dense twin "
          f"{d['done']:.3f} ms); torch ops {torch_ms['static int8'][0]} in "
          f"{torch_ms['static int8'][1]:.3f} ms against "
          f"{torch_ms['dense twin'][0]} in {torch_ms['dense twin'][1]:.3f} "
          f"ms (+{torch_ms['static int8'][1] - torch_ms['dense twin'][1]:.3f}"
          f" ms, {torch_ms['static int8'][0] - torch_ms['dense twin'][0]} "
          f"ops)")
    return dict(static_gb=static_gb, dense_gb=dense_gb,
                decode_ms=runs["static int8"]["decode_ms"],
                twin_decode_ms=runs["dense twin"]["decode_ms"],
                step_ms=s["done"], twin_step_ms=d["done"])


# Training at long sequences: batch 1, 2 layers, 3 steps.  phi3-mini at
# seq 16384 takes the chunked backward, h2o-danube3-4b (window 4096) at
# seq 12288 > 2 x 4096 the banded one (``backward_form``).
LONG_TRAIN_PATHS = {
    "phi3-seq16384": dict(arch="phi3-mini-3.8b", seq=16384, form="chunked"),
    "danube3-seq12288": dict(arch="h2o-danube3-4b", seq=12288,
                             form="banded"),
}
LONG_TRAIN_LAYERS = 2
LONG_TRAIN_STEPS = 3
# The backward forms held to the dense backward: one layer's attention at
# full width, seq 4096.
LONG_FORM_SEQ = 4096


def _long_form_vs_dense(torch, label, cfg):
    """One layer's attention at ``LONG_FORM_SEQ`` (the config's heads,
    window and head width, bf16, seed 5): dq, dk and dv of the form
    ``backward_form`` picks against the dense backward's, within bf16's
    bound of the largest |grad|; each backward timed, its peak printed."""
    from repro_torch.models import attention as A

    t, window = LONG_FORM_SEQ, cfg.window
    form = A.backward_form(t, t, causal=True, window=window)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(1, cfg.n_heads, t, cfg.head_dim, generator=gen,
                    device="cuda").bfloat16()
    k, v = (torch.randn(1, cfg.n_kv_heads, t, cfg.head_dim, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    do = torch.randn_like(q)
    ts = [a.requires_grad_(True) for a in (q, k, v)]
    grads, report = {}, {}
    for what, fn in ((form, lambda: A.attention_core(
            *ts, causal=True, window=window)),
                     ("dense", lambda: A.dense_attention(
                         *ts, causal=True, window=window))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        grads[what] = torch.autograd.grad(fn(), ts, do)
        torch.cuda.synchronize()
        report[what] = (1e3 * (time.perf_counter() - t0),
                        (torch.cuda.max_memory_allocated() - base) / 1e9)
    errs = []
    for name, g, w in zip("qkv", grads[form], grads["dense"]):
        err = (g.float() - w.float()).abs().max().item()
        bound = TOL["bfloat16"]["atol"] * w.float().abs().max().item()
        errs.append(err / max(bound, 1e-30))
        if not err <= bound:
            raise AssertionError(f"{label}: d{name} of the {form} backward "
                                 f"is {err:.3e} from the dense one's "
                                 f"(bound {bound:.3e})")
    print(f"[long-train:{label}] one layer's attention at seq {t} (H "
          f"{cfg.n_heads}:{cfg.n_kv_heads}, D {cfg.head_dim}, window "
          f"{window}): the {form} backward's dq, dk, dv within "
          f"{max(errs):.3f} of bf16's bound of the dense one's; forward + "
          f"backward {report[form][0]:.2f} ms, peak {report[form][1]:.2f} "
          f"GB against dense {report['dense'][0]:.2f} ms, "
          f"{report['dense'][1]:.2f} GB")
    return form


def phase_long_train(torch, *, label, arch, seq, form):
    """Train ``LONG_TRAIN_STEPS`` steps of batch 1 x ``seq`` at
    ``LONG_TRAIN_LAYERS`` layers through ``launch.train.main`` (the step
    captured after the first), then the same run on the eager loop: finite
    losses, exact launch counts (``_want_train_launches`` at this seq),
    the captured run bit-equal to the eager one, step times and peak
    memory; before it, the form's backward against the dense one
    (``_long_form_vs_dense``)."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.launch import train as train_cli
    from repro_torch.models.attention import backward_form

    full = cb.get(arch)
    cfg = dataclasses.replace(full, n_layers=LONG_TRAIN_LAYERS,
                              block_pattern=full.block_pattern[
                                  :LONG_TRAIN_LAYERS])
    picked = backward_form(seq, seq, causal=True, window=cfg.window)
    if picked != form:
        raise AssertionError(f"long-train:{label}: backward form {picked}, "
                             f"want {form}")
    _long_form_vs_dense(torch, label, cfg)
    steps = LONG_TRAIN_STEPS
    argv = ["--arch", arch, "--policy", "bf16", "--batch", "1", "--seq",
            str(seq), "--seed", "0", "--layers", str(LONG_TRAIN_LAYERS),
            "--steps", str(steps)]
    runs, counts = {}, {}
    for what in ("captured", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _reset_counters()
        if what == "captured":
            trainer, params, opt = train_cli.main(argv)
            model = trainer.model
        else:
            trainer, params, opt = _train_eager(torch, model, steps,
                                                batch=1, seq=seq)
        torch.cuda.synchronize()
        counts[what] = _read_counters()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        runs[what] = _run_record(trainer, params, opt, host=True)
        log = runs[what]["log"]
        times = [1e3 * r["time_s"] for r in log]
        print(f"[long-train:{label}] {cfg.name} at {LONG_TRAIN_LAYERS} "
              f"layers, bf16, batch 1 x seq {seq}, {form} attention "
              f"backward, {what}: losses "
              f"{[round(r['loss'], 5) for r in log]}, step times (ms) "
              f"{[round(t, 2) for t in times]}, median of steps 2.. "
              f"{float(np.median(times[1:])):.2f} ms = "
              f"{seq / float(np.median(times[1:])) * 1e3:.1f} tokens/s; "
              f"peak {peak:.2f} GB allocated")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                   for r in log) or len(log) != steps:
            raise AssertionError(f"long-train:{label}: bad metrics {log}")
        if what == "captured" and (trainer.graph is None
                                   or trainer.graph.replays != steps - 1):
            raise AssertionError(f"long-train:{label}: want one capture "
                                 f"and {steps - 1} replays")
        del trainer, params, opt
    want = {key: v * steps for key, v in _want_train_launches(
        model.cfg, seq=seq).items() if key in counts["captured"]}
    got = {k: counts["captured"][k] for k in want}
    print(f"[long-train:{label}] launches over {steps} steps: K1 "
          f"{got['k1']} (wgmma {got['k1_wgmma']}), K4 {got['k4']} (wgmma "
          f"{got['k4_wgmma']})")
    if got != want or counts["eager"] != counts["captured"]:
        raise AssertionError(f"long-train:{label}: launch counts {got} "
                             f"(eager {counts['eager']}), want {want}")
    _check_same_run(f"long-{label}", "captured run vs eager run",
                    _train_distance(torch, runs["captured"], runs["eager"]))
    del runs, model
    gc.collect()
    torch.cuda.empty_cache()


# Loads through a disk pack cache: a packed and a sparse path of phase 7.
PACK_CACHE_PATHS = {
    "phi3-int4": dict(arch="phi3-mini-3.8b", n_layers=16,
                      init=dict(pack=True, pack_format="int4")),
    "granite-sparse-int8": dict(arch="granite-moe-1b-a400m", n_layers=12,
                                policy="int8",
                                init=dict(sparsity=0.5,
                                          sparsity_method="nm")),
}


def phase_pack_cache(torch, *, label, arch, n_layers, init, policy="bf16"):
    """Load the model twice in one process through ``LM.init`` with a
    ``PackedWeightCache`` on a temporary directory as the process's cache:
    the first load (a fresh instance) misses every packed or sparse weight
    and packs each with K6, the second (a new instance on the same
    directory) hits every one off disk and launches no K6; payloads and
    scales byte-equal; both served (4 requests, captured) with the same
    tokens and the served kernels' counts, and one replayed decode step's
    logits bit-equal.  Cold and warm load seconds and the key digest's
    seconds a GB."""
    import dataclasses
    import shutil

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.packing import cache as pc
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse.layout import TileSparseOperand

    tag = f"pack-cache:{label}"
    cfg = dataclasses.replace(cb.get(arch), n_layers=n_layers)
    model = build_model(cfg, policy=policy, device="cuda")
    directory = _ckpt_dir(8e9)
    digest = [0.0, 0]
    plain_digest = pc.weight_digest

    def timed_digest(w):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain_digest(w)
        digest[0] += time.perf_counter() - t0
        digest[1] += w.numel() * w.element_size()
        return out

    prev = pc.set_pack_cache(None)
    pc.weight_digest = timed_digest
    loads = {}
    try:
        for run in ("cold", "warm"):
            cache = pc.PackedWeightCache(directory)
            pc.set_pack_cache(cache)
            pc.reset_lookup_counts()
            digest[:] = [0.0, 0]
            _reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = model.init(torch.Generator(device="cuda").manual_seed(0),
                                **init)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            k6 = _read_counters()["k6"]
            ops = [t for t in _operands(params)]
            n = len(ops)
            want = (0, n, n) if run == "cold" else (n, 0, 0)
            got = (cache.hits, cache.misses, k6)
            print(f"[{tag}] {run} load: {secs:.3f} s, {n} weights, hits "
                  f"{cache.hits}, misses {cache.misses}, K6 launches {k6}; "
                  f"lookups {pc.lookup_counts()}; key digests "
                  f"{digest[1] / 1e9:.3f} GB in {digest[0]:.3f} s = "
                  f"{digest[0] / max(digest[1] / 1e9, 1e-12):.3f} s a GB")
            if got != want:
                raise AssertionError(f"{tag}: {run} load (hits, misses, K6) "
                                     f"{got}, want {want}")
            loads[run] = dict(params=params, secs=secs, ops=ops,
                              s_per_gb=digest[0] / (digest[1] / 1e9))
    finally:
        pc.weight_digest = plain_digest
        pc.set_pack_cache(prev)
        shutil.rmtree(directory, ignore_errors=True)
    for a, b in zip(loads["cold"]["ops"], loads["warm"]["ops"]):
        same = (a.layout == b.layout and torch.equal(
            a.payload.view(torch.uint8), b.payload.view(torch.uint8)) and (
            (a.scales is None and b.scales is None)
            or torch.equal(a.scales, b.scales)))
        if not same:
            raise AssertionError(f"{tag}: a warm payload differs: "
                                 f"{b.layout.describe()}")
    print(f"[{tag}] every warm payload and scale byte-equal to the cold "
          f"load's")
    sparse = isinstance(loads["cold"]["ops"][0], TileSparseOperand)
    tokens, logits = {}, {}
    for run in ("cold", "warm"):
        params = loads[run]["params"]
        out, eng, counts = _serve_requests(torch, model, params, tag)
        _check_serve_counts(f"{tag}:{run}", model.cfg, counts,
                            len(eng.step_telemetry), pack=not sparse,
                            sparse=sparse)
        tokens[run] = out
        del eng
        logits[run] = _captured_step(torch, model, params,
                                     _decode_args(torch, model))().clone()
    torch.cuda.synchronize()
    if tokens["cold"] != tokens["warm"] or not torch.equal(logits["cold"],
                                                           logits["warm"]):
        raise AssertionError(f"{tag}: the warm load serves other tokens or "
                             f"logits than the cold one")
    print(f"[{tag}] served from the warm load: tokens identical, a replayed "
          f"decode step's logits bit-equal to the cold load's")
    assert isinstance(loads["cold"]["ops"][0], (PackedOperand,
                                                TileSparseOperand))
    return dict(cold_s=loads["cold"]["secs"], warm_s=loads["warm"]["secs"],
                digest_s_per_gb=loads["warm"]["s_per_gb"])


def _operands(tree):
    """Every packed or tile-sparse operand of a parameter tree, in order."""
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse.layout import TileSparseOperand
    if isinstance(tree, (PackedOperand, TileSparseOperand)):
        return [tree]
    if isinstance(tree, dict):
        return [op for v in tree.values() for op in _operands(v)]
    if isinstance(tree, list):
        return [op for v in tree for op in _operands(v)]
    return []


def phase_trace_replay(torch, timer=None):
    """The traced-replay fault's reproducer: trace one step of plain torch
    ops first (the profiler, once started, tracks the graphs made after
    it); capture graph A -- granite's training step at full width and
    depth through the training CLI; capture, replay and destroy a second
    training graph -- the training CLI run stopped after its first step
    with a checkpoint and resumed to its fourth, as phase_train's resumed
    run, in a pool of its own -- and a trivial graph of plain torch ops;
    run A once untraced; trace one replay of A with
    ``_profile_decode_step``.  -> {"port": {"ms": the untraced replay's
    ms, "busy_ms": the traced one's device busy time}}; a fault ends the
    process."""
    import shutil

    from repro_torch.launch import train as train_cli

    label = "trace-replay"
    faulthandler.enable()
    x = torch.ones(1 << 20, device="cuda")
    _profile_decode_step(torch, lambda: (x * 2).sum().item(), label, 1.0,
                         what="a step of plain torch ops, before any graph")
    del x
    argv = ["--arch", "granite-moe-1b-a400m", "--policy", "bf16", "--batch",
            "4", "--seq", "128", "--seed", "0"]
    trainer, _, _ = train_cli.main(argv + ["--steps", "2"])
    graph = trainer.graph.graph
    graph.replay()
    torch.cuda.synchronize()
    print(f"[{label}] graph A captured and replayed")

    ckpt = _ckpt_dir(12 * _n_params(trainer.model.cfg))
    try:
        train_cli.main(argv + ["--steps", "1", "--ckpt", ckpt,
                               "--ckpt-every", "1"])
        held, _, _ = train_cli.main(argv + ["--steps", "4", "--ckpt", ckpt,
                                            "--resume"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    del held
    x = torch.ones(1 << 20, device="cuda")
    g3 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g3):
        y = x * 2 + 1
    g3.replay()
    torch.cuda.synchronize()
    del g3, x, y
    gc.collect()
    print(f"[{label}] the resumed trainer's graph and a trivial graph "
          f"captured, replayed and destroyed")

    def replay():
        graph.replay()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    replay()
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"[{label}] graph A replayed untraced: {ms:.2f} ms")
    busy, _ = _profile_decode_step(
        torch, replay, label, ms, what="one replay of graph A after another "
        "graph was captured and destroyed")
    print(f"[{label}] traced replay ran")
    return {"port": dict(ms=ms, busy_ms=busy)}


def main():
    t_start = time.perf_counter()
    faulthandler.enable()        # a crash in native code prints the stack
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall (one nvcc per "
          f"source, in parallel): " + (", ".join(
              f"{n} {t:.1f} s" for n, t in built.items())
              or "nothing to build (up to date)"))
    for name in _build.KERNELS:   # ptxas -v, once per distinct line
        lines = (_build.build_log(name) or "").splitlines()
        for line in dict.fromkeys(ln.strip() for ln in lines
                                  if "registers" in ln or "spill" in ln):
            print(f"[build] {name}: {line}")

    timer = Timer(torch)
    t_phases = time.perf_counter()
    k1 = phase_k1(torch, timer)
    k1_int8 = phase_k1_int8(torch, timer)
    k5, _ = phase_k5(torch, timer)
    k4 = phase_k4(torch, timer)
    k6 = phase_k6(torch, timer)
    k2 = phase_k2(torch, timer)
    k1g = phase_k1_grouped(torch, timer)
    k2g = phase_k2_grouped(torch, timer)
    k6g = phase_k6_grouped(torch, timer)
    k3 = phase_k3(torch, timer)
    k1ta = phase_k1_trans_a(torch, timer)
    k1fma = phase_k1_fma(torch, timer)
    k1a = phase_k1_archs(torch, timer)
    wf = phase_wave_forms(torch, timer)
    k7 = phase_k7(torch, timer)
    packed_grad = phase_packed_grad(torch)
    print(f"[time] kernel phases: {time.perf_counter() - t_phases:.1f} s")
    t_phases = time.perf_counter()
    ops = phase_ops(torch, timer)
    del timer
    serves = {}
    for label, kw in NO_FUSE_PATHS.items():
        serves[label] = phase_serve(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] op-level and --no-fuse phases: "
          f"{time.perf_counter() - t_phases:.1f} s")
    t_phases = time.perf_counter()
    for label, kw in SERVE_PATHS.items():
        serves[label] = phase_serve(torch, label=label, **kw)
        gc.collect()              # free each path's weights before the next
        torch.cuda.empty_cache()
    waves = {}
    for label, kw in WAVE_PATHS.items():
        waves[label] = phase_wave_serve(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] serve phases: {time.perf_counter() - t_phases:.1f} s")
    t_phases = time.perf_counter()
    trains = {}
    for label, kw in TRAIN_PATHS.items():
        trains[label] = phase_train(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] train phases: {time.perf_counter() - t_phases:.1f} s")
    phase_plans(torch)
    t_phases = time.perf_counter()
    for label, kw in STATIC_INT8_PATHS.items():
        phase_static_int8(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    for label, kw in LONG_TRAIN_PATHS.items():
        phase_long_train(torch, label=label, **kw)
    for label, kw in PACK_CACHE_PATHS.items():
        phase_pack_cache(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] static int8, long-sequence training and pack cache "
          f"phases: {time.perf_counter() - t_phases:.1f} s")

    def row(name, source, replaces, launches, numbers, designs=None):
        """One kernel's entry; ``designs`` (or an op row's list of the
        designs its cases ran) counts the launches on each design."""
        if designs is None and "designs" in numbers:
            designs = {d: numbers["designs"].count(d)
                       for d in dict.fromkeys(numbers["designs"])}
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launches,
                    **{k: numbers[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")},
                    library_ms=numbers.get("library_ms"),
                    **({k: numbers[k] for k in (
                        "copy_ms", "bound_f32_fma_ms", "bound_3xtf32_ms",
                        "scalar_ms") if k in numbers}),
                    **({"designs": designs} if designs else {}))

    def wgmma_designs(path, key):     # K2's or K3's launches by design
        return {"wgmma": serves[path][f"{key}_wgmma"],
                "simt": serves[path][key] - serves[path][f"{key}_wgmma"]}

    def stream_designs(counts, key):  # K6's or K7's launches by design
        return {"stream": counts[f"{key}_stream"],
                "simt": counts[key] - counts[f"{key}_stream"]}

    mp = "src/repro/kernels/mpgemm.py"
    fa = "src/repro/kernels/flash_attention.py:154"
    fa4 = "src/repro/kernels/flash_attention.py:31"
    kernels = [
        row("K1 mpgemm (dense 2-D MPGEMM, bf16, fused epilogue)",
            "mpgemm_wgmma.cu", f"{mp}:232", serves["bf16"]["k1"], k1["phi3"]),
        row("K1 mpgemm int8 (dense int8 policy, int32 sum, device scale)",
            "mpgemm_wgmma_int8.cu", f"{mp}:232", serves["int8-dense"]["k1"],
            k1_int8["phi3"]),
        row("K2 mpgemm_packed (int4 payload, bf16 A)",
            "mpgemm_packed_wgmma.cu", f"{mp}:106", serves["int4"]["k2"],
            k2[("phi3", ("bf16", "int4"))], wgmma_designs("int4", "k2")),
        row("K2 mpgemm_packed (int8 payload, int8 A)",
            "mpgemm_packed_wgmma_int8.cu", f"{mp}:106", serves["int8"]["k2"],
            k2[("phi3", ("int8", "int8"))], wgmma_designs("int8", "k2")),
        row("K5 paged_flash (paged flash attention, phi3 decode step)",
            "flash_attention_wgmma.cu", fa, serves["bf16"]["k5"], k5["phi3"],
            serves["bf16"]["k5_designs"]),
        row("K5 paged_flash (phi3 16-token prefill chunk, a launch a "
            "layer)", "flash_attention_wgmma.cu", fa, serves["bf16"]["k5"],
            k5["phi3-chunk"], serves["bf16"]["k5_designs"]),
        row("K1 mpgemm at granite's 2-D shapes (bf16 attention, f32 router, "
            "tied head as B^T)", "mpgemm_wgmma.cu", f"{mp}:232",
            serves["granite-bf16"]["k1"], k1["granite"]),
        row("K1 mpgemm int8 at granite's 2-D shapes (attention, tied head; "
            "the launches include the f32 routers)", "mpgemm_wgmma_int8.cu",
            f"{mp}:232",
            serves["granite-int8-dense"]["k1"], k1_int8["granite"]),
        row("K2 mpgemm_packed at granite's attention (int4 payload, bf16 A)",
            "mpgemm_packed_wgmma.cu", f"{mp}:106",
            serves["granite-int4"]["k2"], k2[("granite", ("bf16", "int4"))],
            wgmma_designs("granite-int4", "k2")),
        row("K2 mpgemm_packed at granite's attention (int8 payload, int8 A)",
            "mpgemm_packed_wgmma_int8.cu", f"{mp}:106",
            serves["granite-int8"]["k2"], k2[("granite", ("int8", "int8"))],
            wgmma_designs("granite-int8", "k2")),
        row("K5 paged_flash at granite's attention (GQA 16:8, D 64, decode "
            "step)", "flash_attention_wgmma.cu", fa,
            serves["granite-bf16"]["k5"], k5["granite"],
            serves["granite-bf16"]["k5_designs"]),
        row("K5 paged_flash at granite's attention (16-token prefill chunk, "
            "a launch a layer)", "flash_attention_wgmma.cu", fa,
            serves["granite-bf16"]["k5"], k5["granite-chunk"],
            serves["granite-bf16"]["k5_designs"]),
        row("K6 pack, stream design (tile packing, int4 payload: ms a "
            "whole phi3-mini, launches a 16-layer load; scalar_ms the "
            "scalar kernel's)", "pack.cu",
            "src/repro/packing/pack.py:221", serves["int4"]["k6"],
            dict(k6["int4"], library_ms=None),
            stream_designs(serves["int4"], "k6")),
        row("K1 mpgemm_grouped (granite expert GEMMs, bf16 A, f32 out, "
            "fused SwiGLU gate)", "mpgemm_wgmma.cu", f"{mp}:812",
            serves["granite-bf16"]["k1g"], k1g["bfloat16"]),
        row("K1 mpgemm_grouped int8 (granite expert GEMMs, int32 sum, "
            "device scale)", "mpgemm_wgmma_int8.cu", f"{mp}:812",
            serves["granite-int8-dense"]["k1g"], k1g["int8"]),
        row("K2 mpgemm_packed_grouped (granite experts, int4 payload, bf16 "
            "A)", "mpgemm_packed_wgmma.cu", f"{mp}:250",
            serves["granite-int4"]["k2g"], k2g[("bf16", "int4")],
            wgmma_designs("granite-int4", "k2g")),
        row("K2 mpgemm_packed_grouped (granite experts, int8 payload, int8 "
            "A)", "mpgemm_packed_wgmma_int8.cu", f"{mp}:250",
            serves["granite-int8"]["k2g"], k2g[("int8", "int8")],
            wgmma_designs("granite-int8", "k2g")),
        row("K6 pack, stream design (granite, int4 payload: ms 96 2-D "
            "weights and 72 grouped expert stacks, launches a 12-layer load; "
            "scalar_ms the scalar kernel's)", "pack.cu",
            "src/repro/packing/pack.py:280",
            serves["granite-int4"]["k6"],
            dict(k6g["int4"], library_ms=None),
            stream_designs(serves["granite-int4"], "k6")),
        row("K4 flash_attention (whisper-medium wave prefill: 24 encoder "
            "1500x1500, 24 causal, 24 cross 32x1500)",
            "flash_attention_wgmma.cu",
            fa4, waves["whisper"]["k4"], k4["whisper-prefill"]),
        row("K4 flash_attention (whisper-medium decode step: 24 cross "
            "1x1500)", "flash_attention_wgmma.cu", fa4, waves["whisper"]["k4"],
            k4["whisper-decode"]),
        row("K4 flash_attention (phi3-mini wave prefill: 32 causal, D 96)",
            "flash_attention_wgmma.cu", fa4, waves["phi3"]["k4"],
            k4["phi3-prefill"]),
        row("K3 mpgemm_sparse (phi3-mini, 50 % magnitude, bf16 A x bf16 "
            "tiles)", "mpgemm_sparse_wgmma.cu", f"{mp}:181",
            serves["phi3-sparse-bf16"]["k3"], k3["phi3-bf16"],
            wgmma_designs("phi3-sparse-bf16", "k3")),
        row("K3 mpgemm_sparse at granite's attention (N:M 2:4, int8 A x int8 "
            "tiles)", "mpgemm_sparse_wgmma_int8.cu", f"{mp}:181",
            serves["granite-sparse-int8"]["k3"], k3["granite-int8"],
            wgmma_designs("granite-sparse-int8", "k3")),
        row("K3 mpgemm_sparse_grouped (granite experts, N:M 2:4, int8 A x "
            "int8 tiles)", "mpgemm_sparse_wgmma_int8.cu", f"{mp}:181",
            serves["granite-sparse-int8"]["k3g"],
            k3["granite-grouped-int8"],
            wgmma_designs("granite-sparse-int8", "k3g")),
        row("K1 mpgemm trans_a (dW of a granite training step, 512 tokens: "
            "attention, f32 routers, tied embedding)", "mpgemm_wgmma.cu",
            f"{mp}:232", trains["granite-bf16"]["counts"]["k1_ta"],
            k1ta["granite"]),
        row("K1 mpgemm_grouped trans_a (dW of granite's expert stacks, 160 "
            "rows each)", "mpgemm_wgmma.cu", f"{mp}:812",
            trains["granite-bf16"]["counts"]["k1g_ta"],
            k1ta["granite-grouped"]),
        row("K1 mpgemm trans_a (dW of a phi3-mini int8 training step, 4 "
            "layers, 512 tokens)", "mpgemm_wgmma.cu", f"{mp}:232",
            trains["phi3-int8-4-layers"]["counts"]["k1_ta"], k1ta["phi3"]),
        row("K7 unpack, stream design (phi3-mini w_up 3072x8192, bf16 "
            "payload, the packed backward; library_ms one PyTorch copy of "
            "the tiles' transposed view, scalar_ms the scalar kernel's)",
            "pack.cu", "src/repro/packing/pack.py:242",
            packed_grad["k7"], k7["up-bf16"],
            stream_designs(packed_grad, "k7")),
        row("K1 f32 FMA design (granite's routers in a bf16 decode step, "
            "the fp32 policy: 24 at M = 2; scalar_ms the scalar loop's)",
            "mpgemm_fma.cu", f"{mp}:232", serves["granite-bf16"]["k1_fma"],
            k1["granite-router"]),
        row("K1 f32 FMA design (the routers of a granite bf16 training step: "
            "forward twice, dX, dW at 512 tokens)", "mpgemm_fma.cu",
            f"{mp}:232", trains["granite-bf16"]["counts"]["k1_fma"],
            k1fma["granite-routers-train"]),
        row("K1 f32 FMA design (every 2-D product of a granite fp32 training "
            "step: forward twice, dX, dW, the tied head; ms at full depth, "
            "24 layers; launches of the 12-layer path)", "mpgemm_fma.cu",
            f"{mp}:232", trains["granite-fp32"]["counts"]["k1_fma"],
            k1fma["granite-fp32-train-2d"]),
        row("K1 f32 FMA design grouped (granite's expert stacks in an fp32 "
            "training step, 160 rows each; ms at full depth, launches of the "
            "12-layer path)", "mpgemm_fma.cu", f"{mp}:812",
            trains["granite-fp32"]["counts"]["k1g_fma"],
            k1fma["granite-fp32-train-grouped"]),
        row("K1 mpgemm at starcoder2-3b's 2-D shapes (decode step: "
            "attention, GELU MLP with biases, head)", "mpgemm_wgmma.cu",
            f"{mp}:232", serves["starcoder2-bf16"]["k1"], k1a["starcoder2"]),
        row("K1 mpgemm at phi3-medium-14b's 2-D shapes (decode step)",
            "mpgemm_wgmma.cu", f"{mp}:232", serves["phi3-medium-bf16"]["k1"],
            k1a["phi3-medium"]),
        row(f"K1 mpgemm at mixtral-8x22b's 2-D shapes (decode step at "
            f"{MIXTRAL_LAYERS} of 56 layers: attention, head; the launches "
            f"and times include the f32 routers)", "mpgemm_wgmma.cu",
            f"{mp}:232", serves["mixtral-bf16"]["k1"], k1a["mixtral"]),
        row("K1 f32 FMA design (mixtral's routers, the fp32 policy; "
            "scalar_ms the scalar loop's)", "mpgemm_fma.cu", f"{mp}:232",
            serves["mixtral-bf16"]["k1_fma"], k1a["mixtral-fma"]),
        row("K1 mpgemm_grouped (mixtral experts, 8 of them top-2, d 6144 "
            "-> 16384, bf16 A, f32 out, fused SwiGLU gate)",
            "mpgemm_wgmma.cu", f"{mp}:812", serves["mixtral-bf16"]["k1g"],
            k1a["mixtral-grouped"]),
        row("K1 mpgemm at llama-3.2-vision-11b's 2-D shapes (wave decode "
            "step: 32 dense and 8 cross layers, head)", "mpgemm_wgmma.cu",
            f"{mp}:232", waves["llama-vision"]["k1"], k1a["vision"]),
        row("K1 mpgemm at rwkv6-1.6b's 2-D shapes (wave decode step: time "
            "and channel mix, head)", "mpgemm_wgmma.cu", f"{mp}:232",
            waves["rwkv6"]["k1"], k1a["rwkv6"]),
        row("K1 f32 FMA design grouped (rwkv6's LoRA: 5 streams, K 32 -> "
            "2048, the fp32 policy; scalar_ms the scalar loop's)",
            "mpgemm_fma.cu", f"{mp}:812", waves["rwkv6"]["k1g"],
            k1a["rwkv6-grouped"]),
        row("K1 mpgemm at recurrentgemma-2b's 2-D shapes (wave decode step: "
            "RG-LRU and local-attention layers, tied head; the launches and "
            "times include the f32 gates)", "mpgemm_wgmma.cu", f"{mp}:232",
            waves["recurrentgemma"]["k1"], k1a["rgemma"]),
        row("K1 f32 FMA design (recurrentgemma's RG-LRU gates, 2560 x 2560, "
            "the fp32 policy; scalar_ms the scalar loop's)", "mpgemm_fma.cu",
            f"{mp}:232", waves["recurrentgemma"]["k1_fma"],
            k1a["rgemma-fma"]),
        row("K5 paged_flash at starcoder2-3b (GQA 12:1, D 128, decode step)",
            "flash_attention_wgmma.cu", fa, serves["starcoder2-bf16"]["k5"],
            k5["starcoder2"], serves["starcoder2-bf16"]["k5_designs"]),
        row("K5 paged_flash at starcoder2-3b (16-token prefill chunk)",
            "flash_attention_wgmma.cu", fa, serves["starcoder2-bf16"]["k5"],
            k5["starcoder2-chunk"], serves["starcoder2-bf16"]["k5_designs"]),
        row("K5 paged_flash at phi3-medium-14b (GQA 4:1, D 128, decode "
            "step)", "flash_attention_wgmma.cu", fa,
            serves["phi3-medium-bf16"]["k5"], k5["phi3-medium"],
            serves["phi3-medium-bf16"]["k5_designs"]),
        row("K5 paged_flash at phi3-medium-14b (16-token prefill chunk)",
            "flash_attention_wgmma.cu", fa, serves["phi3-medium-bf16"]["k5"],
            k5["phi3-medium-chunk"],
            serves["phi3-medium-bf16"]["k5_designs"]),
        row("K5 paged_flash at mixtral-8x22b (GQA 6:1, D 128, window 4096, "
            "decode step)", "flash_attention_wgmma.cu", fa,
            serves["mixtral-bf16"]["k5"], k5["mixtral"],
            serves["mixtral-bf16"]["k5_designs"]),
        row("K5 paged_flash at mixtral-8x22b (16-token prefill chunk)",
            "flash_attention_wgmma.cu", fa, serves["mixtral-bf16"]["k5"],
            k5["mixtral-chunk"], serves["mixtral-bf16"]["k5_designs"]),
        row("K5 paged_flash at mixtral-8x22b past its window (4600-key "
            "context, decode step; times of that context, launches of the "
            "served path)", "flash_attention_wgmma.cu", fa,
            serves["mixtral-bf16"]["k5"], k5["mixtral-window"],
            serves["mixtral-bf16"]["k5_designs"]),
        row("K4 flash_attention (llama-3.2-vision-11b wave prefill: 32 "
            "causal, 8 cross 32 x 1600 image keys, GQA 4:1, D 128)",
            "flash_attention_wgmma.cu", fa4, waves["llama-vision"]["k4"],
            k4["vision-prefill"]),
        row("K4 flash_attention (llama-3.2-vision-11b decode step: 8 cross "
            "1 x 1600)", "flash_attention_wgmma.cu", fa4,
            waves["llama-vision"]["k4"], k4["vision-decode"]),
        row("K4 flash_attention, first scalar kernel (recurrentgemma-2b wave "
            "prefill: 8 local causal, MQA 10:1, D 256 > K4_MAX_D, window "
            "2048)", "flash_attention.cu", fa4,
            waves["recurrentgemma"]["k4"], k4["rgemma-prefill"]),
        row("K1 mpgemm int8 at rwkv6-1.6b's 2-D shapes (wave decode step "
            "under the int8 policy: time and channel mix, lora_a, w_lora_a, "
            "head; f32 weights quantized per call)", "mpgemm_wgmma_int8.cu",
            f"{mp}:232", waves["rwkv6-int8"]["k1"], wf["rwkv6-int8"]),
        row("K2 mpgemm_packed at llama-3.2-vision-11b's 2-D shapes (int8 "
            "payload, int8 A: wave decode step, 32 dense and 8 cross layers, "
            "head)", "mpgemm_packed_wgmma_int8.cu", f"{mp}:106",
            waves["llama-vision-pack-int8"]["k2"], wf["vision-k2-int8"]),
        row("K2 mpgemm_packed, llama-3.2-vision-11b's cross K/V over the "
            "image states at prefill (M = 2 x 1600, int8 payload, int8 A; a "
            "prefill's 16 launches)", "mpgemm_packed_wgmma_int8.cu",
            f"{mp}:106", waves["llama-vision-pack-int8"]["k2"],
            wf["vision-k2-cross-kv"]),
        row("K6 pack, stream design (llama-3.2-vision-11b into int8 at load: "
            "ms a whole model, 281 weights; scalar_ms the scalar kernel's)",
            "pack.cu", "src/repro/packing/pack.py:221",
            waves["llama-vision-pack-int8"]["k6_load"], wf["vision-k6"],
            {"stream": waves["llama-vision-pack-int8"]["k6_stream"],
             "simt": waves["llama-vision-pack-int8"]["k6_load"]
             - waves["llama-vision-pack-int8"]["k6_stream"]}),
        row("K3 mpgemm_sparse at recurrentgemma-2b's 2-D shapes (50 % "
            "magnitude, bf16 A x bf16 tiles: wave decode step; the launches "
            "include the f32 gates)", "mpgemm_sparse_wgmma.cu", f"{mp}:181",
            waves["recurrentgemma-sparse"]["k3"], wf["rgemma-k3-bf16"]),
        row("K3 mpgemm_sparse f32 A x f32 tiles (recurrentgemma-2b's RG-LRU "
            "gates under the fp32 policy, 2560 x 2560, the bf16 payload cast "
            "per call)", "mpgemm_sparse.cu", f"{mp}:181",
            waves["recurrentgemma-sparse"]["k3_f32"], wf["rgemma-k3-f32"]),
        row("K4 flash_attention f32, tf32x3 design (granite fp32 training: "
            "forward and remat, GQA 16:8, D 64, causal 128 x 128; ms at full "
            "depth, launches of the 12-layer path; scalar_ms the first "
            "scalar kernel's)", "flash_attention_tf32x3.cu",
            fa4, trains["granite-fp32"]["counts"]["k4"],
            k4["granite-train-f32"],
            {"tf32x3": trains["granite-fp32"]["counts"]["k4_tf32x3"]}),
        row("K1 mpgemm trans_a (dW of a llama-3.2-vision-11b bf16 training "
            "step at 5 layers, 512 tokens: 4 dense and 1 cross layer, the "
            "cross K/V over 6400 image rows, the untied head)",
            "mpgemm_wgmma.cu", f"{mp}:232",
            trains["llama-vision-bf16-5-layers"]["counts"]["k1_ta"],
            k1ta["vision"]),
        row("K1 mpgemm trans_a (dW of an rwkv6-1.6b bf16 training step at 4 "
            "layers: time and channel mix, lora_a, w_lora_a, the head)",
            "mpgemm_wgmma.cu", f"{mp}:232",
            trains["rwkv6-bf16-4-layers"]["counts"]["k1_ta"],
            k1ta["rwkv6"]),
        row("K1 mpgemm trans_a (dW of a recurrentgemma-2b bf16 training step "
            "at 5 layers: RG-LRU and local attention, the tied embedding; the "
            "f32 gates' dW are the fma row's)", "mpgemm_wgmma.cu",
            f"{mp}:232",
            _wgmma_dw(trains["recurrentgemma-bf16-5-layers"]["counts"]),
            k1ta["rgemma"]),
        row("K1 f32 FMA design grouped (rwkv6-1.6b's 5-stream LoRA in a bf16 "
            "training step at 4 layers: forward twice, dX, dW; scalar_ms the "
            "scalar loop's)", "mpgemm_fma.cu", f"{mp}:812",
            trains["rwkv6-bf16-4-layers"]["counts"]["k1g_fma"],
            k1fma["rwkv6-lora-train"]),
        row("K1 f32 FMA design (recurrentgemma-2b's RG-LRU gates in a bf16 "
            "training step at 5 layers: forward twice, dX, dW; scalar_ms the "
            "scalar loop's)", "mpgemm_fma.cu", f"{mp}:232",
            trains["recurrentgemma-bf16-5-layers"]["counts"]["k1_fma"],
            k1fma["rgemma-gates-train"]),
        row("K4 flash_attention (llama-3.2-vision-11b training at 5 layers: "
            "4 causal 128 x 128 and 1 cross 128 x 1600 image keys, GQA 4:1, "
            "D 128, forward and remat)", "flash_attention_wgmma.cu", fa4,
            trains["llama-vision-bf16-5-layers"]["counts"]["k4"],
            k4["vision-train"]),
        row("K4 flash_attention, first scalar kernel (recurrentgemma-2b "
            "training at 5 layers: 1 local causal 128 x 128, MQA 10:1, D 256 "
            "> K4_MAX_D, forward and remat)", "flash_attention.cu", fa4,
            trains["recurrentgemma-bf16-5-layers"]["counts"]["k4"],
            k4["rgemma-train"]),
    ]
    # The op-level API's rows (phase_ops): launches are each row's driven
    # run; ms, plain_ms, library_ms and bound_ms sum one launch a case.
    ops_rows = [
        ("K1 ops.mpgemm, paper Table III (24 shapes), f32 -> f32",
         "mpgemm_wgmma_f32.cu", f"{mp}:232", "t3/table3-f32"),
        ("K1 mpgemm(f32_fma=True), paper Table III (24 shapes), f32 FMA "
         "(the fp32 policy's design)", "mpgemm_fma.cu", f"{mp}:232",
         "t3/table3-f32-fma"),
        ("K1 ops.mpgemm, paper Table III (24 shapes), bf16 -> bf16",
         "mpgemm_wgmma.cu", f"{mp}:232", "t3/table3-bf16"),
        ("K1 ops.mpgemm, paper Table III (24 shapes), int8 -> int32 "
         "(exact)", "mpgemm_wgmma_int8.cu", f"{mp}:232", "t3/table3-int8"),
        ("K1 beta*C (W1, W13, W19: alpha 1.5, beta 2.0 * C, bias, gelu), "
         "f32", "mpgemm_wgmma_f32.cu", f"{mp}:237", "t3/beta-c-f32"),
        ("K1 beta*C (W1, W13, W19: alpha 1.5, beta 2.0 * C, bias, gelu), "
         "bf16", "mpgemm_wgmma.cu", f"{mp}:237", "t3/beta-c-bf16"),
        ("K1 int8 -> int32 integer epilogue (W1, W13, W19: alpha 2, beta "
         "3 * C, bias)", "mpgemm_wgmma_int8.cu", f"{mp}:232",
         "t3/int32-epilogue"),
        ("K1 int8 trans_a (W13, W19, int32)", "mpgemm_wgmma_int8.cu",
         f"{mp}:232", "t3/int8-trans_a"),
        ("K1 trans_a + trans_b (W13, W19), f32", "mpgemm_wgmma_f32.cu",
         f"{mp}:232", "t3/trans_a+b-f32"),
        ("K1 trans_a + trans_b (W13, W19), bf16", "mpgemm_wgmma.cu",
         f"{mp}:232", "t3/trans_a+b-bf16"),
        ("K1 quant_in tails (phi3 projections, int8 rows x int8 weight, "
         "silu / residual)", "mpgemm_wgmma_int8.cu", f"{mp}:232", "qi/dense"),
        ("K2 quant_in tails, int8 payload", "mpgemm_packed_wgmma_int8.cu",
         f"{mp}:106", "qi/packed-int8"),
        ("K2 quant_in tails, int4 payload", "mpgemm_packed_wgmma_int8.cu",
         f"{mp}:106", "qi/packed-int4"),
        ("K2 int8 A x fp8e4m3 payload (quant_in)", "mpgemm_packed.cu",
         f"{mp}:124", "qi/packed-fp8e4m3"),
        ("K2 quant_in tails, bf16 payload (int8 rows upcast)",
         "mpgemm_packed_wgmma.cu", f"{mp}:106", "qi/packed-bfloat16"),
        ("K3 quant_in tails, int8 tiles (phi3, 0.5 magnitude)",
         "mpgemm_sparse_wgmma_int8.cu", f"{mp}:181", "qi/sparse-int8"),
        ("K3 bf16 A x int8 tiles (phi3 projections, M 2 and 32)",
         "mpgemm_sparse_wgmma.cu", f"{mp}:181", "k3-float"),
        ("K2 beta*C (phi3 w_up, int4 payload, bf16 A)",
         "mpgemm_packed_wgmma.cu", f"{mp}:106", "bc/k2"),
        ("K3 beta*C (phi3 w_up, bf16 tiles, 0.5 magnitude)",
         "mpgemm_sparse_wgmma.cu", f"{mp}:193", "bc/k3"),
        ("K2 trans_a (phi3 w_up, int4 payload, bf16 A read (K, M); the "
         "wrapper copies A^T, copy_ms)", "mpgemm_packed_wgmma.cu",
         f"{mp}:669", "ta/k2"),
        ("K3 trans_a (phi3 w_up, bf16 tiles, 0.5 magnitude, A read (K, M); "
         "the wrapper copies A^T, copy_ms)", "mpgemm_sparse_wgmma.cu",
         f"{mp}:418", "ta/k3"),
        ("K1 mpgemm_grouped beta*C (granite experts, 2 A B + 0.5 C)",
         "mpgemm_wgmma.cu", f"{mp}:812", "g/beta-c"),
        ("K1 mpgemm_grouped quant_in (granite experts, dense bf16 stacks)",
         "mpgemm_wgmma_int8.cu", f"{mp}:812", "g/dense"),
        ("K2 mpgemm_packed_grouped quant_in (granite experts, int8 payload)",
         "mpgemm_packed_wgmma_int8.cu", f"{mp}:250", "g/packed-int8"),
        ("K3 mpgemm_sparse_grouped quant_in (granite experts, int8 N:M 2:4)",
         "mpgemm_sparse_wgmma_int8.cu", f"{mp}:181", "g/sparse-int8"),
        ("K1 mpgemm_grouped via mp_einsum('gmk,gkn->gmn') (granite experts)",
         "mpgemm_wgmma.cu", f"{mp}:812", "g/einsum"),
    ]
    kernels += [row(name, source, replaces, ops[key]["launches"], ops[key])
                for name, source, replaces, key in ops_rows]
    print(f"[time] chip_smoke.py took {time.perf_counter() - t_start:.1f} "
          f"s wall, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
