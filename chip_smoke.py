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
   for int8, whose MN-major operands are transposed in shared memory; the
   rest on ``kernels/csrc/mpgemm.cu``'s scalar loops); then K1's int8
   variant (int8 operands, exact int32 sum, device scale) at the same
   shapes but the router, every launch on the wgmma design;
3. K5 (``kernels/csrc/paged_flash.cu``) against its plain version at
   phi3-mini's and granite's attention shapes (decode and 16-token chunked
   prefill) and at a GQA + sliding-window shape, with ragged lengths, dead
   block-table slots over a NaN-filled scratch page and one idle row; then
   K4 at whisper-medium's shapes (the encoder's 1500 x 1500 non-causal
   self-attention, the decoder's causal prefill, cross-attention at
   prefill and at decode), phi3-mini's causal prefill, a GQA 32:8 head of
   120 with a window and tq < tk, and an f32 case, each on the design
   ``kernels/flash_attention.py::k4_design`` names (bf16: the wgmma or
   the split design of ``kernels/csrc/flash_attention_wgmma.cu``; f32:
   ``kernels/csrc/flash_attention.cu``), the same bits from two
   launches, beside SDPA (no mask where every key is seen,
   ``is_causal`` for a causal square, else the mask);
4. K6 (``kernels/csrc/pack.cu``) packing every full-width phi3-mini weight
   shape and a ragged ``trans_w`` one into bf16, int8, int4 and fp8
   payloads: payload and scales byte-equal to its plain version;
5. K2 (``kernels/csrc/mpgemm_packed.cu``) at phi3-mini's shapes, M = 2
   and 32, for every payload under the bf16 policy (bf16 A) and the int8
   and int4 payloads under the int8 policy (int8 A and its scale), and at
   granite's attention projections for the two served payloads (int4
   under bf16, int8 under int8), against its plain version;
6. the grouped variants at granite-moe-1b-a400m's expert shapes (32
   experts, K/N 1024 <-> 512, M = 2 and 32 rows per expert): grouped K1
   with bf16 A and with int8 A (f32 outputs, the SwiGLU gate fused into
   the gate GEMM), grouped K2 with int4 and bf16 payloads under bf16 A and
   int8 payloads under int8 A, each against its plain version; grouped K6
   packing every weight shape of the model (byte-equal), then all 72
   expert stacks of a full-width model into int4, byte-equal; then K3
   (``kernels/csrc/mpgemm_sparse.cu``) on tile-sparse weights built on the
   card: phi3-mini's GEMMs at 50 % magnitude, bf16 A x bf16 tiles and
   int8 A x int8 tiles with the activation scale, granite's attention
   projections and (grouped) expert stacks under int8 N:M 2:4, and an
   edge case with an empty column and a K tail, at M = 2 and 32;
   after them (in the run's order) K1 ``trans_a``, K7 and the packed
   backward of phase 8;
7a. the op-level API (``phase_ops``) and the kernel variants only it
   reaches, each row driven once with every launch count at 0 and each
   case held against its plain version: the paper's 24 Table III GEMMs
   (``TABLE_III``, a copy of ``benchmarks/common.py``'s) through
   ``kernels.ops.mpgemm`` in f32 -> f32, bf16 -> bf16 and int8 -> int32
   (equal to the plain version; ``torch.matmul`` and ``torch._int_mm`` as
   yardsticks), K1's beta·C and integer epilogues at W1, W13 and W19, int8
   ``trans_a`` and f32 / bf16 ``trans_a`` + ``trans_b`` at W13 and W19
   (each K1 case naming its design); K2 and K3 ``trans_a`` (A read (K,
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
   f32 draw through K6 (113 and 84 launches at load).  Every launch
   count of each run is asserted, every bf16 and int8 K1 launch must have
   run the wgmma design, every logit is finite, and for each path
   one full-width mixed step through the kernels agrees with the same step
   through the plain versions; one two-row decode step of each path is
   timed on the host clock and traced with ``torch.profiler`` (the
   device's busy time and idle share, its ops by kind); then the wave
   engine (``ServeEngine(batch_size=2)``) over the same traffic, dense
   bf16: full-width whisper-medium (24 encoder and 24 decoder layers, 385
   K1 and 72 K4 per prefill, 193 K1 and 24 K4 per decode step) and
   full-width phi3-mini (225 K1 and 32 K4 per prefill, 225 K1 per decode
   step), with the same checks (every K4 launch on the wgmma or split
   design), one prefill and one decode step against the plain versions;
8. the training path: K1 ``trans_a`` (A read (K, M), the weight
   gradients) at a 512-token training step's dW shapes -- granite's
   attention projections, f32 router, tied embedding (49280 x 1024) and
   (grouped) expert stacks at the training capacity, phi3-mini's
   projections and head -- against its plain version and deterministic;
   K7 (the unpacker, ``kernels/csrc/pack.cu``) bit-equal to its plain
   version on every full-width phi3-mini weight packed bf16, int8, int4
   and fp8 and on granite's expert stacks; ``mp_dot`` forward and
   backward on a packed phi3 ``w_up`` (bf16: K2, K7, K1 trans_b and
   trans_a, K6; int4: frozen, dx only) and a bf16 payload's forward under
   int8 (K7, int8 K1), against the plain versions; then
   ``repro_torch.launch.train.main``: full-width granite-moe-1b-a400m, all
   24 layers, bf16, batch 4 x seq 128, remat, 3 steps with a checkpoint,
   and phi3-mini at full width cut to 4 layers under int8 (the STE), 2
   steps -- finite loss and grad norm, exact launch counts a step
   (``_want_train_launches``; the wgmma designs' among them: every bf16
   and int8 K1 launch, every K4 launch), ``--resume`` restoring
   bit-identical
   parameters and AdamW state, one step's loss and gradients against the
   plain versions, step time, tokens/s, peak memory, and one step traced
   with ``torch.profiler``;
9. the script's wall time, one JSON line with every ported kernel's
   launches, error and times;
10. the card line, then ``{"ok": true, "device": {...}}`` as the last
    line.

Times come from CUDA events around single launches, each after a 256 MiB
write that evicts the 50 MB L2 (serving reads every weight cold once per
step).  A kernel's decode-step time is the sum over one full-width decode
step's launches at M = 2, each timed alone.  ``bound_ms`` is the larger of
bytes / 3.35 TB/s and operations / peak (989 TFLOP/s bf16, 67 TFLOP/s f32,
1979 TOP/s int8), counting each input read once and each output written
once.  ``library_ms`` times one
PyTorch call of the same function as a yardstick; the port never calls it.
"""
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
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
    """Mean device milliseconds of single launches, each on a cold L2."""

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
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def _bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


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

    def add(self, per_step, ms, plain_ms, library_ms, bound_ms, n_bytes,
            n_ops):
        self.ms += per_step * ms
        self.plain_ms += per_step * plain_ms
        self.library_ms += per_step * library_ms
        self.bound_ms += per_step * bound_ms
        self.launches += per_step
        self.bytes += per_step * n_bytes
        self.ops += per_step * n_ops

    def row(self, peak_dtype):
        _, bound_by = _bound_ms(self.bytes, self.ops, peak_dtype)
        return dict(ms=self.ms, plain_ms=self.plain_ms,
                    library_ms=self.library_ms, bound_ms=self.bound_ms,
                    bound_by=bound_by, max_abs_err=self.max_abs_err)


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
    # 32-token chunk of prefill).
    steps = {"phi3": StepSum(), "granite": StepSum(),
             "phi3-m32": StepSum(), "granite-m32": StepSum()}
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

        def kern():
            return mpgemm(a, w, bias=bias, extras=extras, spec=spec,
                          epilogue=ep, out_dtype=dt)

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

        (got, design), ref = _k1_design_of(kern), plain()
        torch.cuda.synchronize()
        tol = TOL[_dtype_name(dt)]
        err = _check_close(torch, f"K1 {c['name']} m={m} k={k} n={n}", got,
                           ref, tol)
        for model in ([c["model"], f"{c['model']}-m32"] if c["model"]
                      else steps):
            steps[model].max_abs_err = max(steps[model].max_abs_err, err)
        esz = a.element_size()
        n_bytes = (m * k + k * n + m * n) * esz + m * n * esz * len(extras) \
            + (4 * n if bias is not None else 0)
        n_ops = 2 * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        print(f"[k1] {c['name']:>10} {_dtype_name(dt):>8} {design:>5} "
              f"m={m:<3} k={k:<5} n={n:<6} trans_b={c['trans_b']:d} "
              f"{c['kind']:>8}/{c['act']}: "
              f"err {err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library "
              f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
              f"{n_bytes / ms / 1e6:.1f} GB/s")
        if c["per_step"]:
            key = c["model"] if m == 2 else f"{c['model']}-m32"
            steps[key].add(c["per_step"], ms, plain_ms, lib_ms, bound,
                           n_bytes, n_ops)
    rows = {}
    for model, step in steps.items():
        row = rows[model] = step.row("bfloat16")
        what = ("M=32 chunk of prefill" if model.endswith("-m32") else
                "decode step (M=2)")
        print(f"[k1] one full-width {model.split('-')[0]} {what}, "
              f"{step.launches} launches: kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
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


def phase_k5(torch, timer):
    from repro_torch.kernels.flash_attention import (
        paged_flash_attention, paged_flash_attention_plain,
    )
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    cases = [
        # phi3-mini attention as phase 7 serves it: MHA, D = 96, page 16,
        # a block table 4 pages wide (max_len 64); request 2 is idle, and
        # in the prefill chunk request 1 has 7 dead rows past its length.
        dict(name="phi3-decode", h=32, hkv=32, d=96, ps=16, w=4, tq=1,
             lengths=[45, 30, 0], window=None, dtype=bf16, main="phi3"),
        dict(name="phi3-prefill16", h=32, hkv=32, d=96, ps=16, w=4, tq=16,
             lengths=[48, 9, 0], window=None, dtype=bf16, main=None),
        # granite-moe-1b-a400m's attention as phase 7 serves it: GQA 2:1
        # (16 heads, 8 KV heads), D = 64, the same pages and lengths.
        dict(name="granite-decode", h=16, hkv=8, d=64, ps=16, w=4, tq=1,
             lengths=[45, 30, 0], window=None, dtype=bf16, main="granite"),
        dict(name="granite-prefill16", h=16, hkv=8, d=64, ps=16, w=4,
             tq=16, lengths=[48, 9, 0], window=None, dtype=bf16, main=None),
        # GQA 4:1, D = 120 (not a multiple of 16), window 64, ~200 context
        dict(name="gqa-window-decode", h=32, hkv=8, d=120, ps=16, w=16,
             tq=1, lengths=[201, 64, 0, 9], window=64, dtype=bf16,
             main=None),
        dict(name="gqa-window-prefill16", h=32, hkv=8, d=120, ps=16, w=16,
             tq=16, lengths=[200, 70, 0, 16], window=64, dtype=bf16,
             main=None),
        dict(name="f32-gqa-prefill16", h=8, hkv=2, d=64, ps=16, w=8, tq=16,
             lengths=[40, 100, 0, 3], window=None, dtype=torch.float32,
             main=None),
    ]
    rows, main, max_err = [], {}, 0.0
    for c in cases:
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

        got, ref = kern(), plain()
        torch.cuda.synchronize()
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
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        if c["main"]:
            main[c["main"]] = row
        print(f"[k5] {c['name']:>20} H={c['h']} Hkv={c['hkv']} D={c['d']} "
              f"tq={tq} lengths={c['lengths']} window={c['window']}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.5f} ({bound_by})")
    # Per full-width decode step: one launch per layer of the model's decode
    # case, as the K1 numbers are one decode step's GEMM launches.
    steps = {}
    for model, layers in (("phi3", 32), ("granite", GRANITE_LAYERS)):
        step = steps[model] = {k: layers * main[model][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms")}
        step.update(bound_by=main[model]["bound_by"], max_abs_err=max_err)
        print(f"[k5] one full-width {model} decode step ({layers} launches "
              f"of {model}-decode): kernel {step['ms']:.3f} ms, plain "
              f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} "
              f"ms, bound {step['bound_ms']:.4f} ms ({step['bound_by']})")
    return steps, rows


# ----------------------------------------------------------------- phase 3b

# K4 cases: (name, B, H, Hkv, tq, tk, D, causal, window, dtype, model use).
# Whisper-medium (16 MHA heads of 64) as the wave path runs it: the
# encoder's non-causal self-attention over 1500 frames (not a multiple of
# the kernel's 32-key chunk), the decoder's causal self-attention at a
# 32-token prefill, its cross-attention over the encoder states at prefill
# and at every decode step; phi3-mini's causal prefill (32 heads of 96); a
# danube3-like GQA 32:8 head of 120 with a window shorter than tk and
# tq < tk; an f32 case.
K4_CASES = [
    ("whisper-encoder", 2, 16, 16, 1500, 1500, 64, False, None, "bfloat16"),
    ("whisper-dec-self", 2, 16, 16, 32, 32, 64, True, None, "bfloat16"),
    ("whisper-cross", 2, 16, 16, 32, 1500, 64, False, None, "bfloat16"),
    ("whisper-decode-cross", 2, 16, 16, 1, 1500, 64, False, None,
     "bfloat16"),
    ("phi3-prefill", 2, 32, 32, 32, 32, 96, True, None, "bfloat16"),
    ("gqa-window", 2, 32, 8, 64, 600, 120, True, 256, "bfloat16"),
    ("f32-gqa", 2, 8, 2, 48, 300, 64, True, None, "float32"),
]
WHISPER_LAYERS = 24
PHI3_LAYERS = 32


def _k4_pairs(tq, tk, causal, window):
    """(query row, key) pairs one head sees: the work K4 must do."""
    pairs = 0
    for t in range(tq):
        qi = t + tk - tq
        hi = min(tk - 1, qi) if causal else tk - 1
        lo = max(0, qi - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    return pairs


def phase_k4(torch, timer):
    """K4 against its plain version at the wave path's shapes, each launch
    timed alone on a cold L2, beside the plain version, SDPA (K/V repeated
    for GQA beforehand, not timed) and the bound; each case names the
    design ``k4_design`` ran (bf16: "wgmma" or "split", f32: "simt") and
    the slices over the keys (``k4_split``).  SDPA gets no mask where every
    key is visible, ``is_causal`` for a causal square without a window
    (both keep its flash backend open), else the explicit mask."""
    from repro_torch.kernels.flash_attention import (
        _attention_mask, flash_attention, flash_attention_plain, k4_split,
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
        if design != ("simt" if dt == "float32" else
                      "split" if g * tq <= 16 else "wgmma"):
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
        bound, bound_by = _bound_ms(n_bytes, n_ops, dt)
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound,
                          bound_by=bound_by, bytes=n_bytes, ops=n_ops)
        slices = k4_split(g * tq, tk, b, hkv) if design != "simt" else 1
        print(f"[k4] {name:>20} {dt:>8} {design:>5} x{slices:<2} B={b} "
              f"H={h} Hkv={hkv} D={d} "
              f"tq={tq} tk={tk} causal={causal:d} window={window}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library (SDPA) "
              f"{lib_ms:.4f} {sdpa and next(iter(sdpa)) or 'no mask'}  "
              f"bound {bound:.4f} ({bound_by})  "
              f"{n_ops / ms / 1e9:.1f} TFLOP/s")

    def total(label, parts):
        """Times of the launches ``parts`` = {case: launches} summed."""
        out = {key: sum(n * rows[c][key] for c, n in parts.items())
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        n_bytes = sum(n * rows[c]["bytes"] for c, n in parts.items())
        n_ops = sum(n * rows[c]["ops"] for c, n in parts.items())
        out["bound_by"] = _bound_ms(n_bytes, n_ops, "bfloat16")[1]
        out["max_abs_err"] = max(rows[c]["max_abs_err"] for c in rows)
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
    }


# ------------------------------------------------------------------ phase 4

PAYLOADS = ("bfloat16", "int8", "int4", "fp8e4m3")


def phase_k6(torch, timer):
    """K6 against its plain version: byte-equal payload and scales; each
    pack timed against its bytes bound (source read once, payload and
    scales written once)."""
    from repro_torch.packing.pack import pack_operand, pack_reference
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(5)
    # (name, source shape, trans_w, packs per full-width model)
    shapes = [(name, (k, n), False, per_step)
              for name, k, n, _, _, per_step in MAIN_SHAPES if name != "gate"]
    shapes = [(nm, sh, tw, 2 * c if nm == "up" else c)
              for nm, sh, tw, c in shapes]       # up and gate: one shape
    shapes.append(("ragged-trans_w", (1000, 3000), True, 0))
    model = {fmt: StepSum() for fmt in PAYLOADS}
    for name, shape, trans_w, per_model in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * \
            (2.0 / sum(shape)) ** 0.5
        k, n = shape[::-1] if trans_w else shape
        for fmt in PAYLOADS:
            def kern():
                return pack_operand(w, default_blocks(k, n), trans_w=trans_w,
                                    dtype=fmt)

            got = kern()
            layout = got.layout

            def plain():
                return pack_reference(w, layout)

            payload, scales = plain()
            torch.cuda.synchronize()
            same = torch.equal(got.payload.contiguous().view(torch.uint8),
                               payload.contiguous().view(torch.uint8))
            if scales is not None:
                same = same and torch.equal(got.scales.view(torch.int32),
                                            scales.view(torch.int32))
            if not same:
                raise AssertionError(f"K6 {name} {fmt}: payload or scales "
                                     "differ from the plain version")
            n_bytes = w.numel() * w.element_size() + got.nbytes
            bound, bound_by = _bound_ms(n_bytes, 0, "float32")
            ms, plain_ms = timer(kern), timer(plain)
            print(f"[k6] {name:>14} {str(shape):>13} trans_w={trans_w:d} "
                  f"-> {fmt:>8} {tuple(layout.payload_shape)}: byte-equal  "
                  f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  bound "
                  f"{bound:.4f} ({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s")
            model[fmt].add(per_model, ms, plain_ms, 0.0, bound, n_bytes, 0)
    rows = {}
    for fmt, acc in model.items():
        rows[fmt] = acc.row("float32")
        print(f"[k6] packing a full-width phi3-mini ({acc.launches} weights) "
              f"into {fmt}: kernel {acc.ms:.3f} ms, plain "
              f"{acc.plain_ms:.3f} ms, bound {acc.bound_ms:.3f} ms")
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

                got, ref = kern(), plain()
                torch.cuda.synchronize()
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
                print(f"[k2] {name:>5} m={m:<3} {policy:>4} A x {fmt:>8}: "
                      f"err {err:.2e}  kernel {ms:.4f} ms  plain "
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

                got, ref = kern(), plain()
                torch.cuda.synchronize()
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
                      f"{fmt:>8}: err {err:.2e}  kernel {ms:.4f} ms  plain "
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
    projections 2-D, expert stacks grouped in one launch) timed and
    byte-equal to its plain version, summed over the model; then every one
    of the model's 72 expert stacks, freshly drawn, packed into int4 and
    checked byte for byte."""
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

    def same(got, want):
        payload, scales = want
        ok = torch.equal(got.payload.contiguous().view(torch.uint8),
                         payload.contiguous().view(torch.uint8))
        if scales is not None:
            ok = ok and torch.equal(got.scales.view(torch.int32),
                                    scales.view(torch.int32))
        return ok

    for name, shape, per_model in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * \
            (2.0 / sum(shape[-2:])) ** 0.5
        k, n = shape[-2:]
        for fmt in PAYLOADS:
            def kern():
                return pack_operand(w, default_blocks(k, n), dtype=fmt)

            got = kern()
            layout = got.layout

            def plain():
                return pack_reference(w, layout)

            want = plain()
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"K6 granite {name} {fmt}: payload or "
                                     "scales differ from the plain version")
            n_bytes = w.numel() * w.element_size() + got.nbytes
            bound, bound_by = _bound_ms(n_bytes, 0, "float32")
            ms, plain_ms = timer(kern), timer(plain)
            print(f"[k6-grouped] {name:>15} {str(shape):>16} -> {fmt:>8} "
                  f"{tuple(layout.payload_shape)}: byte-equal  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f}  bound {bound:.4f} "
                  f"({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s")
            model[fmt].add(per_model, ms, plain_ms, 0.0, bound, n_bytes, 0)
    t0 = time.perf_counter()
    for i in range(3 * layers):
        k, n = (512, 1024) if i % 3 == 2 else (1024, 512)
        w = torch.randn(g, k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        got = pack_operand(w, default_blocks(k, n), dtype="int4")
        if not same(got, pack_reference(w, got.layout)):
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
              f"launches) into {fmt}: kernel {acc.ms:.3f} ms, plain "
              f"{acc.plain_ms:.3f} ms, bound {acc.bound_ms:.3f} ms")
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
    """K3 (``kernels/csrc/mpgemm_sparse.cu``) against its plain version:
    phi3-mini's GEMMs at 50 % magnitude (bf16 A x bf16 tiles, and int8 A x
    int8 tiles with the activation scale), granite's attention projections
    and expert stacks (grouped) under int8 N:M 2:4, an empty column and a
    K tail.  Times per launch on a cold L2; bound from the stored-tile, A
    and output bytes or the stored tiles' operations; the library time is
    ``torch.matmul`` on the weight densified beforehand, plus the
    epilogue."""
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import (
        mpgemm_sparse, mpgemm_sparse_grouped, mpgemm_sparse_plain,
    )
    from repro_torch.sparse import densify_operand

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

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = _check_close(torch, f"K3 {name} m={m} {policy}", got, ref,
                               TOL[_dtype_name(out_dtype)])
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
                  f"{policy:>4} d={lay.density:.3f}: err {err:.2e}  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
                  f"bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s")
            if row:
                steps[row].max_abs_err = max(steps[row].max_abs_err, err)
                if m == 2:
                    steps[row].add(per_step, ms, plain_ms, lib_ms, bound,
                                   n_bytes, n_ops)
        del b, w_lib
    rows = {}
    for row, st in steps.items():
        r = rows[row] = st.row("int8" if "int8" in row else "bfloat16")
        print(f"[k3] one full-width decode step, {row} (M=2, {st.launches} "
              f"launches): kernel {r['ms']:.3f} ms, plain "
              f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms "
              f"(densified beforehand), bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']})")
    return rows


# ------------------------------------------------------------------ phase 7

def _counters():
    from repro_torch.kernels.flash_attention import (
        flash_attention, paged_flash_attention,
    )
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_packed, mpgemm_packed_grouped,
        mpgemm_sparse, mpgemm_sparse_grouped,
    )
    from repro_torch.packing.pack import pack_operand, unpack_operand
    return dict(k1=mpgemm, k1g=mpgemm_grouped, k2=mpgemm_packed,
                k2g=mpgemm_packed_grouped, k3=mpgemm_sparse,
                k3g=mpgemm_sparse_grouped, k4=flash_attention,
                k5=paged_flash_attention, k6=pack_operand, k7=unpack_operand)


def _reset_counters():
    """Every launch count to 0 (the per-variant and per-design counts
    too)."""
    c = _counters()
    for fn in c.values():
        fn.launches = 0
    for name in ("k1", "k1g"):
        c[name].trans_b_launches = c[name].wgmma_launches = 0
    for name in ("k1", "k1g", "k2", "k2g", "k3", "k3g"):
        c[name].trans_a_launches = 0
    c["k4"].wgmma_launches = c["k4"].split_launches = 0


def _read_counters():
    """Every launch count, K1's and grouped K1's ``trans_a`` and
    ``trans_b`` ones as ``k1_ta`` / ``k1_tb`` / ``k1g_ta`` / ``k1g_tb``,
    those that ran K1's wgmma design as ``k1_wgmma`` / ``k1g_wgmma``, and
    K4's on its wgmma and split designs as ``k4_wgmma`` / ``k4_split``."""
    c = _counters()
    out = {name: fn.launches for name, fn in c.items()}
    for name in ("k1", "k1g"):
        out[f"{name}_ta"] = c[name].trans_a_launches
        out[f"{name}_tb"] = c[name].trans_b_launches
        out[f"{name}_wgmma"] = c[name].wgmma_launches
    # (0 on a tree without them: chip_ab.py)
    out["k4_wgmma"] = getattr(c["k4"], "wgmma_launches", 0)
    out["k4_split"] = getattr(c["k4"], "split_launches", 0)
    return out


def _k4_design_of(call):
    """Run ``call`` (one K4 launch) -> (its output, the design that ran it:
    "wgmma", "split" or "simt", read off the counters)."""
    fn = _counters()["k4"]

    def count(design):
        return getattr(fn, f"{design}_launches", 0)

    before = (count("wgmma"), count("split"))
    out = call()
    return out, ("wgmma" if count("wgmma") > before[0] else
                 "split" if count("split") > before[1] else "simt")


def _check_k4_designs(label, counts):
    """Every K4 launch of a path ran a Hopper design (``k4_design``): its
    operands are bf16 with head widths the rule takes."""
    new = counts["k4_wgmma"] + counts["k4_split"]
    print(f"[{label}] K4 designs: wgmma {counts['k4_wgmma']}, split "
          f"{counts['k4_split']} of {counts['k4']} launches")
    if new != counts["k4"]:
        raise AssertionError(f"{label}: {counts['k4'] - new} K4 launches "
                             f"ran the scalar kernel, want none")


def _k1_design_of(call):
    """Run ``call`` (one K1 launch, 2-D or grouped) -> (its output, the
    design that ran it: "wgmma" or "simt", read off the counters)."""
    c = _counters()

    def wgmma():      # (0 on a tree without the wgmma design: chip_ab.py)
        return sum(getattr(c[k], "wgmma_launches", 0) for k in ("k1", "k1g"))

    before = wgmma()
    out = call()
    return out, "wgmma" if wgmma() > before else "simt"


def _check_wgmma(label, got, want):
    """Every bf16 and int8 K1 launch of a path ran the wgmma design: ``got``
    and ``want`` map ``k1`` / ``k1g`` to wgmma launches and bf16 and int8
    launches."""
    print(f"[{label}] wgmma design: K1 {got['k1']} of {want['k1']} bf16 / "
          f"int8 launches, grouped K1 {got['k1g']} of {want['k1g']}")
    if got != want:
        raise AssertionError(f"{label}: wgmma launches {got}, want every "
                             f"bf16 and int8 K1 launch: {want}")


def _want_launches(cfg, pack, n_steps, sparse=False):
    """Every launch count of a serve run: per ``paged_step`` each layer has
    4 attention projections, then 3 dense MLP GEMMs or (MoE) 1 f32 router
    GEMM and 3 grouped expert GEMMs, plus the head.  Packing (K2) or
    sparsifying (K3) covers every projection, MLP weight and expert stack
    and an untied head, never the router or a tied head (the embedding),
    and takes one K6 pack launch per weight at load."""
    n_layers, moe = cfg.n_layers, cfg.family == "moe"
    dense_2d = 1 if moe else 3            # router | gate, up, down
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

    step_calls, finite = [], []
    inner = model.paged_step

    def counted_step(*args):
        logits, caches = inner(*args)
        step_calls.append(1)
        finite.append(bool(torch.isfinite(logits.float()).all()))
        return logits, caches

    model.paged_step = counted_step
    eng = ServeEngine(model, params, max_len=64, max_batch=2, page_size=16)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        2, cfg.vocab, (int(rng.integers(4, 33)),)).astype(np.int32),
        max_new_tokens=16) for i in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    wgmma = {name: counters[name].wgmma_launches for name in ("k1", "k1g")}
    del model.paged_step
    n_steps = len(step_calls)
    want, per_step = _want_launches(cfg, pack, n_steps, sparse=sparsity > 0)
    n_tok = sum(len(v) for v in out.values())
    decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
    prefill = [s.wall_s for s in eng.step_telemetry if s.phase != "decode"]
    print(f"[serve:{label}] 4 requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {n_tok} tokens in {wall:.3f} s "
          f"= {n_tok / wall:.2f} tok/s; {n_steps} paged_step calls "
          f"({len(prefill)} with prefill, median "
          f"{1e3 * np.median(prefill):.2f} ms); median decode step "
          f"{1e3 * np.median(decode):.2f} ms")
    print(f"[serve:{label}] launches: K1 {counts['k1']}, grouped K1 "
          f"{counts['k1g']}, K2 {counts['k2']}, grouped K2 {counts['k2g']}, "
          f"K3 {counts['k3']}, grouped K3 {counts['k3g']}, "
          f"K5 {counts['k5']} ({n_steps} steps x {per_step} and "
          f"{n_layers} attention layers), K6 {counts['k6']} at load")
    # eos (id 1) may end a request early; every request must finish.
    if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
        raise AssertionError(f"served {sorted(out)} of 4 requests")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    # bf16 and int8 K1 launches: all of them but the MoE routers (f32),
    # under either policy (every width of both models is a multiple of 16).
    routers = n_layers if cfg.family == "moe" else 0
    _check_wgmma(f"serve:{label}", wgmma, dict(
        k1=(per_step["k1"] - routers) * n_steps,
        k1g=per_step["k1g"] * n_steps))
    if not all(finite):
        raise AssertionError("non-finite logits during serving")
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 steps=n_steps, payload_gb=payload / 1e9,
                 decode_step_ms=1e3 * float(np.median(decode)),
                 ttft_ms=1e3 * float(np.median(prefill)), **counts)
    serve["logit_err"] = _kernel_vs_plain_step(torch, model, params, label)
    if not fused:
        serve["fused_logit_err"] = _kernel_vs_plain_step(
            torch, model, params, label,
            against=dataclasses.replace(model, fused_epilogues=True))
    args = _decode_args(torch, model)

    def step():
        return model.paged_step(params, *args)

    serve["enqueue_ms"], serve["step_ms"] = _decode_step_times(torch, step)
    print(f"[serve:{label}] one two-row decode step: the host enqueues it "
          f"in {serve['enqueue_ms']:.2f} ms, the device is done after "
          f"{serve['step_ms']:.2f} ms")
    _profile_decode_step(torch, step, label, serve["step_ms"])
    return serve


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


def _plain_gemm(a, b, *, spec, out_dtype=None, c=None, **kw):
    """The plain version of a call ``core/gemm.py`` makes to its GEMM
    wrappers (``mpgemm`` or ``mpgemm_grouped``), by the form of ``b``."""
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
def _plain_versions(enabled=True):
    """Within the block, every GEMM, attention, unpack (K7) and pack (K6)
    wrapper the model and its backward call is its plain version (the
    plain versions are rank-generic: they stand in for the 2-D and the
    grouped GEMM wrappers alike, ``trans_a`` and ``trans_b`` included)."""
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
    for n, fn in zip(names, (_plain_gemm, _plain_gemm, plain_unpack,
                             plain_pack)):
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
          f"{rel * scale:.3e}), argmax agreement {top_agree:.2f}")
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
                 ("mpgemm_packed_kernel", "K2"), ("mpgemm_int8_kernel", "K1"),
                 ("mpgemm_kernel", "K1"), ("mpgemm_wgmma_kernel", "K1 wgmma"),
                 ("paged_flash_kernel", "K5"),
                 ("flash_wgmma_kernel", "K4 wgmma"),
                 ("flash_split_kernel", "K4 split"), ("flash_kernel", "K4"),
                 ("pack_kernel", "K6"))


def _profile_decode_step(torch, step, label, step_ms,
                         what="one two-row decode step"):
    """One two-row decode step (``step()``; ``what`` names another step)
    under ``torch.profiler``: the
    device's busy time (the union of its kernels' and copies' spans)
    against the traced step's span (from the step's first host op to its
    last device op) and against ``step_ms``, the same step's time untraced
    (tracing slows the host, not the kernels); the device's ops by kind,
    and the host calls in the step that copy or wait."""
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
    # Kernels, copies and sets; the trace also mirrors the "traced_step"
    # annotation on the device, which is no work of the device.
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "traced_step" and e.time_range.end >= t0),
                 key=lambda e: e.time_range.start)
    if not dev:
        print(f"[profile:{label}] the profiler saw no device activity: "
              f"device busy time not measured")
        return
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
    top = sorted(names.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"[profile:{label}] the device's longest ops (count, ms): " +
          "; ".join(f"{name[:90]} {n} {ms:.3f}" for name, (n, ms) in top))
    print(f"[profile:{label}] host calls in the step that copy or wait "
          f"(with their callers): {waits or 'none'}")


# ----------------------------------------------------------------- phase 7b

def _want_wave_launches(cfg):
    """K1 and K4 launches per prefill and per decode step of the wave path.

    Whisper (enc-dec): each encoder layer runs 4 attention projections and
    2 MLP GEMMs and one non-causal K4; each decoder layer at prefill 4
    self-attention projections, 4 cross-attention ones (q, k and v of the
    encoder states, o) and 2 MLP GEMMs, with a causal K4 and a cross K4; at
    a decode step the cross K/V come from the cache, so 4 + 2 + 2 GEMMs and
    one cross K4 (the self-attention against the ring cache is plain torch
    ops, as in the reference).  A dense decoder: 7 GEMMs a layer, one
    causal K4 a layer at prefill.  Both add the head."""
    n, enc = cfg.n_layers, cfg.encoder_layers
    if cfg.family == "audio":
        return (dict(k1=enc * 6 + n * 10 + 1, k4=enc + 2 * n),
                dict(k1=n * 8 + 1, k4=n))
    return dict(k1=n * 7 + 1, k4=n), dict(k1=n * 7 + 1, k4=0)


def phase_wave_serve(torch, *, label, arch, n_layers=None):
    """Serve 4 requests through the wave engine (``ServeEngine(batch_size=
    2)``); every launch count of the run must be what its prefills and
    decode steps need."""
    import dataclasses
    import warnings

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = cb.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, policy="bf16", device="cuda")
    cfg = model.cfg
    counters = _counters()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    enc = (f" + {cfg.encoder_layers} encoder layers over "
           f"{cfg.encoder_seq} frames" if cfg.encoder_layers else "")
    print(f"[wave:{label}] {cfg.name}, {cfg.n_layers} decoder layers{enc}, "
          f"dense bf16: {weights / 1e9:.3f} GB of weights, initialised on "
          f"the card in {t_init:.3f} s")

    calls = {"prefill": 0, "decode": 0}
    finite = []
    inner_prefill, inner_decode = model.prefill, model.decode_step

    def counted(kind, fn):
        def call(*args, **kw):
            logits, caches = fn(*args, **kw)
            calls[kind] += 1
            finite.append(bool(torch.isfinite(logits.float()).all()))
            return logits, caches
        return call

    model.prefill = counted("prefill", inner_prefill)
    model.decode_step = counted("decode", inner_decode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = ServeEngine(model, params, batch_size=2, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(
        2, cfg.vocab, (int(rng.integers(4, 33)),)).astype(np.int32),
        max_new_tokens=16) for i in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    wgmma = {name: counters[name].wgmma_launches for name in ("k1", "k1g")}
    del model.prefill, model.decode_step
    per_prefill, per_decode = _want_wave_launches(cfg)
    want = {k: 0 for k in counters}
    for key in ("k1", "k4"):
        want[key] = (calls["prefill"] * per_prefill[key]
                     + calls["decode"] * per_decode[key])
    n_tok = sum(len(v) for v in out.values())
    decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
    prefill = [w.prefill_s for w in eng.telemetry]
    print(f"[wave:{label}] 4 requests (prompts "
          f"{[len(r.prompt) for r in reqs]}) in {len(eng.telemetry)} waves "
          f"of 2, {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; "
          f"{calls['prefill']} prefills ("
          + ", ".join(f"{1e3 * p:.2f}" for p in prefill) + " ms), "
          f"{calls['decode']} decode steps (median "
          f"{1e3 * np.median(decode):.2f} ms)")
    print(f"[wave:{label}] launches: K1 {counts['k1']}, K4 {counts['k4']} "
          f"({calls['prefill']} prefills x {per_prefill} + "
          f"{calls['decode']} decode steps x {per_decode}), K5 "
          f"{counts['k5']}, K2 {counts['k2']}, grouped K1 {counts['k1g']}")
    if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
        raise AssertionError(f"served {sorted(out)} of 4 requests")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    # Dense bf16 and no router: every K1 launch is a bf16 one.
    _check_wgmma(f"wave:{label}", wgmma, dict(k1=counts["k1"], k1g=0))
    _check_k4_designs(f"wave:{label}", _read_counters())
    if not all(finite):
        raise AssertionError("non-finite logits during serving")
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 weights_gb=weights / 1e9, prefills=calls["prefill"],
                 decode_steps=calls["decode"], prefill_ms=[
                     1e3 * p for p in prefill],
                 decode_step_ms=1e3 * float(np.median(decode)), **counts)
    batch = _wave_batch(torch, model)
    serve["logit_err"] = _wave_kernel_vs_plain(torch, model, params, label,
                                               batch)
    _, caches = model.prefill(params, batch, max_len=64)
    pos = batch["tokens"].shape[1]
    token = torch.tensor([[5], [7]], device="cuda")

    def step():
        return model.decode_step(params, token, caches, pos)

    serve["enqueue_ms"], serve["step_ms"] = _decode_step_times(torch, step)
    print(f"[wave:{label}] one two-row decode step: the host enqueues it "
          f"in {serve['enqueue_ms']:.2f} ms, the device is done after "
          f"{serve['step_ms']:.2f} ms")
    _profile_decode_step(torch, step, f"wave:{label}", serve["step_ms"])
    return serve


def _wave_batch(torch, model):
    """A two-row prefill batch, 16 tokens and a row left-padded to 16 from
    9 (stubbed zero audio frames for whisper)."""
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
    return batch


def _wave_kernel_vs_plain(torch, model, params, label, batch):
    """One full-width prefill and one decode step through the kernels and
    through the plain versions; both logits within the bf16 bound."""
    token = torch.tensor([[11], [13]], device="cuda")
    pos = batch["tokens"].shape[1]
    runs = []
    for plain in (False, True):
        with _plain_versions(enabled=plain):
            logits, caches = model.prefill(params, batch, max_len=64)
            step, _ = model.decode_step(params, token, caches, pos)
        runs.append((logits.float()[:, :model.cfg.vocab],
                     step.float()[:, :model.cfg.vocab]))
        del caches
    errs = []
    for what, lk, lp in (("prefill", runs[0][0], runs[1][0]),
                         ("decode step", runs[0][1], runs[1][1])):
        diff = (lk - lp).abs()
        err, scale = diff.max().item(), lp.abs().max().item()
        rel = LOGIT_REL_TOL["bf16"]
        agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        print(f"[wave:{label}] one full-width {what}, kernels vs plain "
              f"versions: max |logit diff| {err:.3e}, mean "
              f"{diff.mean().item():.3e} (bound {rel} x max |logit| = "
              f"{rel * scale:.3e}), argmax agreement {agree:.2f}")
        if not (err <= rel * scale and torch.isfinite(lk).all()):
            raise AssertionError(f"{what}: kernel and plain logits differ "
                                 f"by {err:.3e}")
        errs.append(err)
    return max(errs)


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


def phase_k1_trans_a(torch, timer):
    """K1 with A read (K, M): the weight gradients of a training step at
    512 tokens, bf16 operands (f32 for the router) with f32 outputs, each
    against its plain version and beside ``torch.matmul(a.t(), b)``; then
    the deterministic check (two launches, the same bits)."""
    from repro_torch.core.gemm_spec import GemmSpec
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped, \
        mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(8)
    steps = {"granite": StepSum(), "granite-grouped": StepSum(),
             "phi3": StepSum()}
    for name, model, m, n, dt, per_step, g in TRANS_A_CASES:
        dtype = getattr(torch, dt)
        t = GRANITE_TRAIN_ROWS if g else TRAIN_TOKENS
        lead = (g,) if g else ()
        a = torch.randn(*lead, t, m, generator=gen, device="cuda").to(dtype)
        b = torch.randn(*lead, t, n, generator=gen, device="cuda").to(dtype)
        fn = mpgemm_grouped if g else mpgemm
        spec = GemmSpec(grouped=bool(g), trans_a=True)

        def kern():
            return fn(a, b, spec=spec, out_dtype=torch.float32)

        def plain():
            return mpgemm_plain(a, b, trans_a=True, out_dtype=torch.float32)

        def library():
            return torch.matmul(a.transpose(-1, -2), b).float()

        (got, design), again, ref = _k1_design_of(kern), kern(), plain()
        torch.cuda.synchronize()
        err = _check_close(torch, f"K1 trans_a {name}", got, ref,
                           TOL["float32"])
        if not torch.equal(got, again):
            raise AssertionError(f"K1 trans_a {name}: two launches differ")
        groups = g or 1
        n_bytes = groups * (t * (m + n) * a.element_size() + m * n * 4)
        n_ops = 2 * groups * m * n * t
        bound, bound_by = _bound_ms(n_bytes, n_ops, dt)
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        print(f"[k1-trans_a] {name:>18} {dt:>8} {design:>5} G={g or 1:<2} "
              f"M={m:<5} "
              f"N={n:<5} K={t}: err {err:.2e} (f32 out, rtol 1e-4, atol "
              f"1e-4), deterministic  kernel {ms:.4f} ms  plain "
              f"{plain_ms:.4f}  library {lib_ms:.4f}  bound {bound:.4f} "
              f"({bound_by})  {n_ops / ms / 1e9:.1f} TFLOP/s")
        key = f"{model}-grouped" if g else model
        steps[key].max_abs_err = max(steps[key].max_abs_err, err)
        steps[key].add(per_step, ms, plain_ms, lib_ms, bound, n_bytes, n_ops)
    rows = {}
    for key, acc in steps.items():
        rows[key] = acc.row("bfloat16")
        print(f"[k1-trans_a] the dW GEMMs of one {key} training step "
              f"({acc.launches} launches): kernel {acc.ms:.3f} ms, plain "
              f"{acc.plain_ms:.3f} ms, library {acc.library_ms:.3f} ms, "
              f"bound {acc.bound_ms:.3f} ms ({rows[key]['bound_by']})")
    return rows


def phase_k7(torch, timer):
    """K7 (the tile unpacker) against its plain version, bit for bit:
    every full-width phi3-mini weight shape packed as int4, int8, fp8 and
    bf16 (each unpacked to bf16), and granite's expert stacks; each timed
    against its bytes bound (payload and scales read once, the dense
    operand written once)."""
    from repro_torch.packing.pack import (
        pack_operand, unpack_operand, unpack_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = [(nm, (k, n), 2 * c if nm == "up" else c)
              for nm, k, n, _, _, c in MAIN_SHAPES if nm != "gate"]
    shapes += [("g-experts-up/gate", (GRANITE_EXPERTS, 1024, 512), 0),
               ("g-experts-down", (GRANITE_EXPERTS, 512, 1024), 0)]
    model = {fmt: StepSum() for fmt in PAYLOADS}
    rows = {}
    for name, shape, per_model in shapes:
        w = torch.randn(*shape, generator=gen, device="cuda") * 0.02
        for fmt in PAYLOADS:
            p = pack_operand(w, (128, 128), dtype=fmt)

            def kern():
                return unpack_operand(p, dtype="bfloat16")

            def plain():
                return unpack_reference(p.payload, p.scales, p.layout,
                                        "bfloat16")

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                raise AssertionError(f"K7 {name} {fmt}: output differs from "
                                     "the plain version")
            n_bytes = p.nbytes + got.numel() * got.element_size()
            bound, bound_by = _bound_ms(n_bytes, 0, "float32")
            ms, plain_ms = timer(kern), timer(plain)
            print(f"[k7] {name:>18} {str(shape):>16} {fmt:>8} -> bf16: "
                  f"bit-equal  kernel {ms:.4f} ms  plain {plain_ms:.4f}  "
                  f"bound {bound:.4f} ({bound_by})  "
                  f"{n_bytes / ms / 1e6:.1f} GB/s")
            model[fmt].add(per_model, ms, plain_ms, 0.0, bound, n_bytes, 0)
            if name == "up" and fmt == "bfloat16":
                rows["up-bf16"] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=bound_by,
                                       max_abs_err=0.0)
    for fmt, acc in model.items():
        rows[fmt] = acc.row("float32")
        print(f"[k7] unpacking a full-width phi3-mini ({acc.launches} "
              f"weights) from {fmt}: kernel {acc.ms:.3f} ms, plain "
              f"{acc.plain_ms:.3f} ms, bound {acc.bound_ms:.3f} ms")
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
    # fwd, K7, dx; bf16/int8: K7, then int8 K1.
    want_counts = dict(k2=2, k7=3, k1=4, k1_tb=2, k1_ta=1, k6=1)
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
    the row's numbers (times summed over its cases, one launch each); a
    K1 case names the design it ran."""
    _reset_counters()
    ran = [_k1_design_of(c["kern"]) for c in cases]
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
        bound, bound_by = _bound_ms(c["n_bytes"], c["n_ops"], c["peak"])
        ms = timer(c["kern"], OPS_ITERS)
        plain_ms = timer(c["plain"], OPS_ITERS)
        lib_ms = timer(c["library"], OPS_ITERS) if library else 0.0
        case_copy = timer(c["copy"], OPS_ITERS) if c["copy"] else None
        copy_ms += case_copy or 0.0
        acc.max_abs_err = max(acc.max_abs_err, err)
        acc.add(1, ms, plain_ms, lib_ms, bound, c["n_bytes"], c["n_ops"])
        rate = c["n_ops"] / ms / 1e9
        print(f"[ops:{label}] {c['name']:>24}"
              + (f" {design:>5}" if counter in ("k1", "k1g") else "") + ": "
              + ("equal" if c["exact"] else f"err {err:.2e}")
              + f"  kernel {ms:.4f} ms"
              + (f" (A copy {case_copy:.4f})" if case_copy else "")
              + f"  plain {plain_ms:.4f}"
              + (f"  library {lib_ms:.4f}" if library else "")
              + f"  bound {bound:.4f} ({bound_by})  {rate:.2f} TOP/s")
    designs = [design for _, design in ran]
    del ran
    row = acc.row(cases[0]["peak"])
    row["library_ms"] = row["library_ms"] if library else None
    row["launches"] = counts[counter]
    row["designs"] = designs
    if any(c["copy"] for c in cases):
        row["copy_ms"] = copy_ms
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


def _table3_rows(torch, timer, gen):
    """The paper's GEMMs: the 24 Table III shapes through ``ops.mpgemm`` in
    f32 -> f32, bf16 -> bf16 and int8 -> int32 (equal to the plain
    version); then the epilogue cases (W1, W13, W19) and the transposed
    ones (W13, W19)."""
    from repro_torch.kernels import ops

    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    def operands(m, n, k, dt, trans_a=False, trans_b=False):
        if dt == i8:
            a = torch.randint(-127, 128, (k, m) if trans_a else (m, k),
                              generator=gen, device="cuda", dtype=i8)
            b = torch.randint(-127, 128, (n, k) if trans_b else (k, n),
                              generator=gen, device="cuda", dtype=i8)
            return a, b
        a = torch.randn(*((k, m) if trans_a else (m, k)), generator=gen,
                        device="cuda").to(dt)
        # B ~ N(0, 1/K): outputs of unit scale, as a weight's init gives.
        b = (torch.randn(*((n, k) if trans_b else (k, n)), generator=gen,
                         device="cuda") * k ** -0.5).to(dt)
        return a, b

    rows = {}
    for label, dt in (("f32", f32), ("bf16", bf16), ("int8", i8)):
        cases = []
        for wid, m, n, k in TABLE_III:
            a, b = operands(m, n, k, dt)
            esz = a.element_size()
            out_esz = 4 if dt == i8 else esz
            if dt == i8:
                library = (lambda a=a, b=b: torch._int_mm(a, b))
            else:
                library = (lambda a=a, b=b: torch.matmul(a, b))
            cases.append(_ops_case(
                f"W{wid} {m}x{n}x{k}",
                lambda a=a, b=b: ops.mpgemm(a, b),
                lambda a=a, b=b: _ops_plain(a, b),
                library=library, exact=dt == i8,
                n_bytes=(m * k + k * n) * esz + m * n * out_esz,
                n_ops=2 * m * n * k,
                peak={f32: "float32", bf16: "bfloat16", i8: "int8"}[dt]))
        rows[f"table3-{label}"] = _ops_row(torch, timer, f"table3-{label}",
                                           "k1", cases)
        # The rule sends every bf16 and int8 shape of the table to wgmma.
        if dt != f32 and set(rows[f"table3-{label}"]["designs"]) != {
                "wgmma"}:
            raise AssertionError(f"table3-{label}: designs "
                                 f"{rows[f'table3-{label}']['designs']}")
        del cases
        gc.collect()
        torch.cuda.empty_cache()

    shapes = {wid: (m, n, k) for wid, m, n, k in TABLE_III}
    cases, int_cases = [], []
    for wid in EPILOGUE_WORKLOADS:
        m, n, k = shapes[wid]
        for dt in (f32, bf16, i8):
            a, b = operands(m, n, k, dt)
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
            case = _ops_case(
                f"W{wid} {_dtype_name(dt)}",
                lambda a=a, b=b, c=c, kw=kw: ops.mpgemm(a, b, c, **kw),
                lambda a=a, b=b, c=c, kw=kw: _ops_plain(a, b, c, **kw),
                exact=dt == i8,
                n_bytes=(m * k + k * n) * esz + 4 * n
                + m * n * c.element_size() + m * n * (4 if dt == i8 else esz),
                n_ops=2 * m * n * k,
                peak={f32: "float32", bf16: "bfloat16", i8: "int8"}[dt])
            (int_cases if dt == i8 else cases).append(case)
    rows["beta-c"] = _ops_row(torch, timer, "beta-c", "k1", cases)
    rows["int32-epilogue"] = _ops_row(torch, timer, "int32-epilogue", "k1",
                                      int_cases)

    cases, int_cases = [], []
    for wid in TRANS_WORKLOADS:
        m, n, k = shapes[wid]
        a, b = operands(m, n, k, i8, trans_a=True)
        int_cases.append(_ops_case(
            f"W{wid} int8 trans_a",
            lambda a=a, b=b: ops.mpgemm(a, b, trans_a=True),
            lambda a=a, b=b: _ops_plain(a, b, trans_a=True),
            library=lambda a=a, b=b: torch._int_mm(a.t(), b),
            exact=True, n_bytes=(m * k + k * n) + 4 * m * n,
            n_ops=2 * m * n * k, peak="int8"))
        for dt in (f32, bf16):
            a, b = operands(m, n, k, dt, trans_a=True, trans_b=True)
            esz = a.element_size()
            cases.append(_ops_case(
                f"W{wid} {_dtype_name(dt)} trans_a+b",
                lambda a=a, b=b: ops.mpgemm(a, b, trans_a=True, trans_b=True),
                lambda a=a, b=b: _ops_plain(a, b, trans_a=True,
                                                  trans_b=True),
                library=lambda a=a, b=b: torch.matmul(a.t(), b.t()),
                n_bytes=(m * k + k * n + m * n) * esz, n_ops=2 * m * n * k,
                peak="float32" if dt == f32 else "bfloat16"))
    rows["int8-trans_a"] = _ops_row(torch, timer, "int8-trans_a", "k1",
                                    int_cases)
    for key in ("int32-epilogue", "int8-trans_a"):
        if set(rows[key]["designs"]) != {"wgmma"}:
            raise AssertionError(f"{key}: designs {rows[key]['designs']}")
    rows["trans_a+b"] = _ops_row(torch, timer, "trans_a+b", "k1", cases)
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


def _laid_out_beta_c_rows(torch, timer, gen):
    """beta·C on K2 (phi3 ``w_up`` packed int4, bf16 A) and on K3 (the
    same weight tile-sparse bf16 at 0.5), M = 2 and 32, through
    ``ops.mpgemm(a, operand, c, beta=...)``."""
    from repro_torch.kernels import ops
    from repro_torch.packing.pack import pack_operand
    from repro_torch.packing.params import default_blocks

    bf16 = torch.bfloat16
    k, n = 3072, 8192
    w = torch.randn(k, n, generator=gen, device="cuda") * (2 / (k + n)) ** .5
    operands = {"k2": pack_operand(w, default_blocks(k, n), dtype="int4"),
                "k3": _sparse_weight(torch, gen, (k, n), "bfloat16",
                                     "magnitude")}
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
                n_bytes=2 * m * k + b.nbytes + 4 * m * n, n_ops=n_ops,
                peak="bfloat16"))
        rows[counter] = _ops_row(torch, timer, f"beta-c-{counter}", counter,
                                 cases)
    return rows


def _laid_out_trans_a_rows(torch, timer, gen):
    """``trans_a`` on K2 (phi3 ``w_up`` packed int4, bf16 A) and on K3
    (the same weight tile-sparse bf16 at 0.5), A read (K, M) with M = 2
    and 32, through ``ops.mpgemm(a, operand, trans_a=True)``: the wrapper
    copies Aᵀ to (M, K) rows, timed alone beside the call."""
    from repro_torch.kernels import ops
    from repro_torch.packing.pack import pack_operand
    from repro_torch.packing.params import default_blocks

    k, n = 3072, 8192
    w = torch.randn(k, n, generator=gen, device="cuda") * (2 / (k + n)) ** .5
    operands = {"k2": pack_operand(w, default_blocks(k, n), dtype="int4"),
                "k3": _sparse_weight(torch, gen, (k, n), "bfloat16",
                                     "magnitude")}
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


def _want_train_launches(cfg, remat=True, seq=128, policy="bf16"):
    """Kernel launches of one training step (forward, the rematerialised
    forward, backward) of a dense model: per layer 4 attention GEMMs and
    the MLP's 3 (a dense model) or the f32 router and 3 grouped expert
    GEMMs (MoE), one K4; the head GEMM once per loss chunk, which the loss
    always rematerialises.  The backward: dx (K1 ``trans_b`` for a (k, n)
    weight; a tied head's dx reads the (V, d) embedding as it is) and dW
    (``trans_a``) for every GEMM, plus the recompute of z for the gated
    SwiGLU GEMM; attention's backward is torch ops (no K4).  K7 never runs:
    the weights are dense.  The wgmma design runs every bf16 and int8 K1
    launch (``k1_wgmma``, ``k1g_wgmma``): all but the f32 routers'
    (forward, dx, dW), under either policy.  K4 runs
    its split design when a kv head's G·seq folded rows number at most 16
    (``k4_design``; the smoke configs), else its wgmma design (``k4_wgmma``,
    ``k4_split``)."""
    n, moe, tied = cfg.n_layers, cfg.family == "moe", cfg.tie_embeddings
    r = 2 if remat else 1
    chunks = -(-seq // 512)
    fwd_2d = 4 + (1 if moe else 3)              # + router | up, gate, down
    bwd_2d = 2 * fwd_2d + (0 if moe else 1)     # dense gate: z again
    want = dict(k2=0, k2g=0, k3=0, k3g=0, k5=0, k6=0, k7=0)
    want["k1"] = n * (r * fwd_2d + bwd_2d) + 2 * chunks + 2
    want["k1_ta"] = n * fwd_2d + 1
    want["k1_tb"] = n * fwd_2d + (2 * chunks if tied else 1)
    want["k1g"] = n * (r * 3 + 7) if moe else 0   # gate: z again
    want["k1g_ta"] = want["k1g_tb"] = 3 * n if moe else 0
    want["k4"] = r * n
    want["k1_wgmma"] = want["k1g_wgmma"] = 0
    if policy in ("bf16", "int8"):
        want["k1_wgmma"] = want["k1"] - ((r + 2) * n if moe else 0)
        want["k1g_wgmma"] = want["k1g"]
    split = cfg.n_heads // cfg.n_kv_heads * seq <= 16
    want["k4_split"] = want["k4"] if split else 0
    want["k4_wgmma"] = 0 if split else want["k4"]
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


def _train_kernel_vs_plain(torch, model, params, batch, label):
    """One step's loss and gradients through the kernels and through the
    plain versions, from the same parameters and batch, with the same
    expert choices (``_shared_routing``)."""
    from repro_torch.train.train_step import _value_and_grad

    with _shared_routing() as route:
        with route("record"):
            lk, gk = _value_and_grad(model, params, batch)
        with route("replay"), _plain_versions():
            lp, gp = _value_and_grad(model, params, batch)
    tol = TRAIN_TOL["int8" if model.policy == "int8" else "bf16"]
    leaf_tol = tol["leaf"]
    nk = float(torch.sqrt(sum((g.float() ** 2).sum()
                              for _, g in _tree_paths(gk))))
    np_ = float(torch.sqrt(sum((g.float() ** 2).sum()
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
    """Parameters of a dense or MoE decoder (rope, no learned positions):
    embedding, untied head, per layer the attention projections, two
    norms and the MLP (or router and expert stacks), the final norm."""
    d, hd, vp = cfg.d_model, cfg.head_dim, -(-cfg.vocab // 128) * 128
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    mlp = (d * cfg.n_experts + 3 * cfg.n_experts * d * cfg.d_ff
           if cfg.family == "moe" else 3 * d * cfg.d_ff)
    return (vp * d * (1 if cfg.tie_embeddings else 2)
            + cfg.n_layers * (attn + 2 * d + mlp) + d)


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


def phase_train(torch, *, label, arch, policy, steps, n_layers=None):
    """Train through ``repro_torch.launch.train.main``: ``steps`` steps of
    batch 4 x seq 128 with remat, a checkpoint after the last step, then
    ``--resume`` (which restores it and has no step left to run): finite
    loss and grad norm, exact launch counts of every step, restored
    parameters and AdamW state bit-equal to the run's, and one step
    through the kernels against the same step through the plain
    versions; then one step traced with ``torch.profiler``."""
    import dataclasses
    import shutil

    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import SyntheticLM, device_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.adamw import tree_leaves

    cfg = cb.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    argv = ["--arch", arch, "--policy", policy, "--batch", "4", "--seq",
            "128", "--seed", "0"]
    if n_layers is not None:
        argv += ["--layers", str(n_layers)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
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
        peak = torch.cuda.max_memory_allocated() / 1e9
        model = trainer.model
        want = {key: v * steps for key, v in _want_train_launches(
            model.cfg, policy=policy).items()}
        log = trainer.metrics_log
        n_params = sum(p.numel() for p in tree_leaves(params))
        times = [r["time_s"] for r in log]
        step_ms = 1e3 * float(np.median(times[1:])) if len(times) > 1 \
            else 1e3 * times[0]
        print(f"[train:{label}] {model.cfg.name}, {model.cfg.n_layers} "
              f"layers, {n_params / 1e9:.3f} B f32 params, policy {policy}, "
              f"remat, batch 4 x seq 128: {steps} steps in {wall:.2f} s "
              f"(checkpoint included); losses "
              f"{[round(r['loss'], 5) for r in log]}, grad norms "
              f"{[round(r['grad_norm'], 5) for r in log]}, step times (ms) "
              f"{[round(1e3 * t, 2) for t in times]}; median of steps 2.. "
              f"{step_ms:.2f} ms = {TRAIN_TOKENS / step_ms * 1e3:.1f} "
              f"tokens/s; peak {peak:.2f} GB allocated")
        print(f"[train:{label}] launches over {steps} steps: {counts}")
        if not all(np.isfinite(r["loss"]) and r["loss"] > 0
                   and np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
                   for r in log) or len(log) != steps:
            raise AssertionError(f"train {label}: bad metrics {log}")
        if counts != {**{k: 0 for k in counts}, **want}:
            raise AssertionError(f"train {label}: launch counts {counts}, "
                                 f"want {want}")
        print(f"[train:{label}] wgmma design: K1 {counts['k1_wgmma']} of "
              f"{counts['k1']} launches, grouped K1 {counts['k1g_wgmma']} "
              f"of {counts['k1g']} (every bf16 and int8 one)")
        _check_k4_designs(f"train:{label}", counts)

        t0 = time.perf_counter()
        _, p_res, o_res = train_cli.main(
            argv + ["--steps", str(steps), "--ckpt", ckpt, "--resume"])
        t_res = time.perf_counter() - t0
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params) + tree_leaves(opt),
            tree_leaves(p_res) + tree_leaves(o_res)))
        print(f"[train:{label}] --resume restored step {steps} in "
              f"{t_res:.2f} s: params and AdamW state (m, v, step) "
              f"bit-identical: {same}")
        if not same or int(o_res.step) != steps:
            raise AssertionError(f"train {label}: the restored state differs")
        del p_res, o_res
        gc.collect()

        batch = device_batch(SyntheticLM(model.cfg.vocab, 4, 128,
                                         seed=7).next_batch(), "cuda")
        errs = _train_kernel_vs_plain(torch, model, params, batch, label)

        def step():
            trainer.step_fn(params, opt, batch)
            torch.cuda.synchronize()

        _profile_decode_step(torch, step, f"train:{label}", step_ms,
                             what="one training step")
    finally:
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    return dict(counts=counts, step_ms=step_ms, wall_s=wall, peak_gb=peak,
                tokens_per_s=TRAIN_TOKENS / step_ms * 1e3, **errs)


def main():
    t_start = time.perf_counter()
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
    for label, arch in (("whisper", "whisper-medium"),
                        ("phi3", "phi3-mini-3.8b")):
        waves[label] = phase_wave_serve(torch, label=label, arch=arch)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] serve phases: {time.perf_counter() - t_phases:.1f} s")
    t_phases = time.perf_counter()
    granite = "granite-moe-1b-a400m"
    trains = {}
    for label, kw in (("granite-bf16", dict(arch=granite, policy="bf16",
                                             steps=3)),
                      ("phi3-int8-4-layers", dict(arch="phi3-mini-3.8b",
                                                  policy="int8", steps=2,
                                                  n_layers=4))):
        trains[label] = phase_train(torch, label=label, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[time] train phases: {time.perf_counter() - t_phases:.1f} s")

    def row(name, source, replaces, launches, numbers):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launches,
                    **{k: numbers[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")},
                    library_ms=numbers.get("library_ms"),
                    **({"copy_ms": numbers["copy_ms"]}
                       if "copy_ms" in numbers else {}))

    mp = "src/repro/kernels/mpgemm.py"
    fa = "src/repro/kernels/flash_attention.py:154"
    fa4 = "src/repro/kernels/flash_attention.py:31"
    kernels = [
        row("K1 mpgemm (dense 2-D MPGEMM, bf16, fused epilogue)",
            "mpgemm_wgmma.cu", f"{mp}:232", serves["bf16"]["k1"], k1["phi3"]),
        row("K1 mpgemm int8 (dense int8 policy, int32 sum, device scale)",
            "mpgemm_wgmma_int8.cu", f"{mp}:232", serves["int8-dense"]["k1"],
            k1_int8["phi3"]),
        row("K2 mpgemm_packed (int4 payload, bf16 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int4"]["k2"], k2[("phi3", ("bf16", "int4"))]),
        row("K2 mpgemm_packed (int8 payload, int8 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int8"]["k2"], k2[("phi3", ("int8", "int8"))]),
        row("K5 paged_flash (paged flash attention)", "paged_flash.cu", fa,
            serves["bf16"]["k5"], k5["phi3"]),
        row("K1 mpgemm at granite's 2-D shapes (bf16 attention, f32 router, "
            "tied head as B^T)", "mpgemm_wgmma.cu", f"{mp}:232",
            serves["granite-bf16"]["k1"], k1["granite"]),
        row("K1 mpgemm int8 at granite's 2-D shapes (attention, tied head; "
            "the launches include the f32 routers)", "mpgemm_wgmma_int8.cu",
            f"{mp}:232",
            serves["granite-int8-dense"]["k1"], k1_int8["granite"]),
        row("K2 mpgemm_packed at granite's attention (int4 payload, bf16 A)",
            "mpgemm_packed.cu", f"{mp}:106", serves["granite-int4"]["k2"],
            k2[("granite", ("bf16", "int4"))]),
        row("K2 mpgemm_packed at granite's attention (int8 payload, int8 A)",
            "mpgemm_packed.cu", f"{mp}:106", serves["granite-int8"]["k2"],
            k2[("granite", ("int8", "int8"))]),
        row("K5 paged_flash at granite's attention (GQA 16:8, D 64)",
            "paged_flash.cu", fa, serves["granite-bf16"]["k5"],
            k5["granite"]),
        row("K6 pack (tile packing, int4 payload: ms a whole phi3-mini, "
            "launches a 16-layer load)", "pack.cu",
            "src/repro/packing/pack.py:221", serves["int4"]["k6"],
            dict(k6["int4"], library_ms=None)),
        row("K1 mpgemm_grouped (granite expert GEMMs, bf16 A, f32 out, "
            "fused SwiGLU gate)", "mpgemm_wgmma.cu", f"{mp}:812",
            serves["granite-bf16"]["k1g"], k1g["bfloat16"]),
        row("K1 mpgemm_grouped int8 (granite expert GEMMs, int32 sum, "
            "device scale)", "mpgemm_wgmma_int8.cu", f"{mp}:812",
            serves["granite-int8-dense"]["k1g"], k1g["int8"]),
        row("K2 mpgemm_packed_grouped (granite experts, int4 payload, bf16 "
            "A)", "mpgemm_packed.cu", f"{mp}:250",
            serves["granite-int4"]["k2g"], k2g[("bf16", "int4")]),
        row("K2 mpgemm_packed_grouped (granite experts, int8 payload, int8 "
            "A)", "mpgemm_packed.cu", f"{mp}:250",
            serves["granite-int8"]["k2g"], k2g[("int8", "int8")]),
        row("K6 pack (granite, int4 payload: ms 96 2-D weights and 72 "
            "grouped expert stacks, launches a 12-layer load)", "pack.cu",
            "src/repro/packing/pack.py:280",
            serves["granite-int4"]["k6"],
            dict(k6g["int4"], library_ms=None)),
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
            "tiles)", "mpgemm_sparse.cu", f"{mp}:181",
            serves["phi3-sparse-bf16"]["k3"], k3["phi3-bf16"]),
        row("K3 mpgemm_sparse at granite's attention (N:M 2:4, int8 A x int8 "
            "tiles)", "mpgemm_sparse.cu", f"{mp}:181",
            serves["granite-sparse-int8"]["k3"], k3["granite-int8"]),
        row("K3 mpgemm_sparse_grouped (granite experts, N:M 2:4, int8 A x "
            "int8 tiles)", "mpgemm_sparse.cu", f"{mp}:181",
            serves["granite-sparse-int8"]["k3g"],
            k3["granite-grouped-int8"]),
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
        row("K7 unpack (phi3-mini w_up 3072x8192, bf16 payload, the packed "
            "backward)", "pack.cu", "src/repro/packing/pack.py:242",
            packed_grad["k7"], dict(k7["up-bf16"], library_ms=None)),
    ]
    # The op-level API's rows (phase_ops): launches are each row's driven
    # run; ms, plain_ms, library_ms and bound_ms sum one launch a case.
    ops_rows = [
        ("K1 ops.mpgemm, paper Table III (24 shapes), f32 -> f32",
         "mpgemm.cu", f"{mp}:232", "t3/table3-f32"),
        ("K1 ops.mpgemm, paper Table III (24 shapes), bf16 -> bf16",
         "mpgemm_wgmma.cu", f"{mp}:232", "t3/table3-bf16"),
        ("K1 ops.mpgemm, paper Table III (24 shapes), int8 -> int32 "
         "(exact)", "mpgemm_wgmma_int8.cu", f"{mp}:232", "t3/table3-int8"),
        ("K1 beta*C (W1, W13, W19: alpha 1.5, beta 2.0 * C, bias, gelu; "
         "f32 and bf16)", "mpgemm.cu", f"{mp}:237", "t3/beta-c"),
        ("K1 int8 -> int32 integer epilogue (W1, W13, W19: alpha 2, beta "
         "3 * C, bias)", "mpgemm_wgmma_int8.cu", f"{mp}:232",
         "t3/int32-epilogue"),
        ("K1 int8 trans_a (W13, W19, int32)", "mpgemm_wgmma_int8.cu",
         f"{mp}:232", "t3/int8-trans_a"),
        ("K1 trans_a + trans_b (W13, W19, f32 and bf16)", "mpgemm.cu",
         f"{mp}:232", "t3/trans_a+b"),
        ("K1 quant_in tails (phi3 projections, int8 rows x int8 weight, "
         "silu / residual)", "mpgemm_wgmma_int8.cu", f"{mp}:232", "qi/dense"),
        ("K2 quant_in tails, int8 payload", "mpgemm_packed.cu", f"{mp}:106",
         "qi/packed-int8"),
        ("K2 quant_in tails, int4 payload", "mpgemm_packed.cu", f"{mp}:106",
         "qi/packed-int4"),
        ("K2 int8 A x fp8e4m3 payload (quant_in)", "mpgemm_packed.cu",
         f"{mp}:124", "qi/packed-fp8e4m3"),
        ("K2 quant_in tails, bf16 payload (int8 rows upcast)",
         "mpgemm_packed.cu", f"{mp}:106", "qi/packed-bfloat16"),
        ("K3 quant_in tails, int8 tiles (phi3, 0.5 magnitude)",
         "mpgemm_sparse.cu", f"{mp}:181", "qi/sparse-int8"),
        ("K3 bf16 A x int8 tiles (phi3 projections, M 2 and 32)",
         "mpgemm_sparse.cu", f"{mp}:181", "k3-float"),
        ("K2 beta*C (phi3 w_up, int4 payload, bf16 A)", "mpgemm_packed.cu",
         f"{mp}:106", "bc/k2"),
        ("K3 beta*C (phi3 w_up, bf16 tiles, 0.5 magnitude)",
         "mpgemm_sparse.cu", f"{mp}:193", "bc/k3"),
        ("K2 trans_a (phi3 w_up, int4 payload, bf16 A read (K, M); the "
         "wrapper copies A^T, copy_ms)", "mpgemm_packed.cu", f"{mp}:669",
         "ta/k2"),
        ("K3 trans_a (phi3 w_up, bf16 tiles, 0.5 magnitude, A read (K, M); "
         "the wrapper copies A^T, copy_ms)", "mpgemm_sparse.cu", f"{mp}:418",
         "ta/k3"),
        ("K1 mpgemm_grouped beta*C (granite experts, 2 A B + 0.5 C)",
         "mpgemm_wgmma.cu", f"{mp}:812", "g/beta-c"),
        ("K1 mpgemm_grouped quant_in (granite experts, dense bf16 stacks)",
         "mpgemm_wgmma_int8.cu", f"{mp}:812", "g/dense"),
        ("K2 mpgemm_packed_grouped quant_in (granite experts, int8 payload)",
         "mpgemm_packed.cu", f"{mp}:250", "g/packed-int8"),
        ("K3 mpgemm_sparse_grouped quant_in (granite experts, int8 N:M 2:4)",
         "mpgemm_sparse.cu", f"{mp}:181", "g/sparse-int8"),
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
