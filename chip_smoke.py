#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit; build every kernel from ``csrc/`` with
   nvcc (one process per source, in parallel) and print the build seconds;
2. K1 (``kernels/csrc/mpgemm.cu``) against its plain version at the
   full-width phi3-mini and granite-moe-1b-a400m 2-D GEMM shapes (decode
   M = 2 and chunked prefill M = 32; granite's attention projections, its
   f32 router and its tied head read as B^T), a ragged edge case and an
   f32 case; then K1's int8 variant (int8 operands, exact int32 sum,
   device scale) at the same shapes but the router;
3. K5 (``kernels/csrc/paged_flash.cu``) against its plain version at
   phi3-mini's and granite's attention shapes (decode and 16-token chunked
   prefill) and at a GQA + sliding-window shape, with ragged lengths, dead
   block-table slots over a NaN-filled scratch page and one idle row; then
   K4 (``kernels/csrc/flash_attention.cu``) at whisper-medium's shapes
   (the encoder's 1500 x 1500 non-causal self-attention, the decoder's
   causal prefill, cross-attention at prefill and at decode), phi3-mini's
   causal prefill, a GQA 32:8 head of 120 with a window and tq < tk, and
   an f32 case, each beside SDPA with the same mask;
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
7. serving 4 requests through ``repro_torch.serve.engine.ServeEngine``:
   full-width phi3-mini-3.8b (random weights from a seed), dense bf16 (225
   K1 and 32 K5 launches per ``paged_step``), packed from the f32 draw by
   K6 with int4 payloads under bf16 and with int8 payloads under the int8
   policy (225 K2, 32 K5 and 0 K1 launches per step), and dense under the
   int8 policy at 4 layers (29 int8 K1 launches per step); then full-width
   granite-moe-1b-a400m over the same traffic, dense bf16 (121 K1, 72
   grouped K1, 24 K5 per step), packed int4 under bf16 and packed int8
   under int8 (96 K2, 72 grouped K2, 25 K1 -- routers and the tied head --
   and 24 K5 per step; 168 K6 launches at load), and dense int8 at 4
   layers (21 K1 and 12 grouped K1 per step); and the two tile-sparse
   paths at full width: phi3-mini under bf16 at sparsity 0.5 by magnitude
   (225 K3, 32 K5 and 0 K1 per step) and granite under int8 with N:M 2:4
   (96 K3, 72 grouped K3, 25 K1, 24 K5 per step), each sparsified from
   the f32 draw through K6 (225 and 168 launches at load).  Every launch
   count of each run is asserted, every logit is finite, and for each path
   one full-width mixed step through the kernels agrees with the same step
   through the plain versions; one two-row decode step of each path is
   timed on the host clock and traced with ``torch.profiler`` (the
   device's busy time and idle share, its ops by kind); then the wave
   engine (``ServeEngine(batch_size=2)``) over the same traffic, dense
   bf16: full-width whisper-medium (24 encoder and 24 decoder layers, 385
   K1 and 72 K4 per prefill, 193 K1 and 24 K4 per decode step) and
   full-width phi3-mini (225 K1 and 32 K4 per prefill, 225 K1 per decode
   step), with the same checks, one prefill and one decode step against
   the plain versions;
8. one JSON line with every ported kernel's launches, error and times;
9. the card line, then ``{"ok": true, "device": {...}}`` as the last line.

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

    steps = {"phi3": StepSum(), "granite": StepSum()}
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

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = TOL[_dtype_name(dt)]
        err = _check_close(torch, f"K1 {c['name']} m={m} k={k} n={n}", got,
                           ref, tol)
        for model in ([c["model"]] if c["model"] else steps):
            steps[model].max_abs_err = max(steps[model].max_abs_err, err)
        esz = a.element_size()
        n_bytes = (m * k + k * n + m * n) * esz + m * n * esz * len(extras) \
            + (4 * n if bias is not None else 0)
        n_ops = 2 * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        print(f"[k1] {c['name']:>10} {_dtype_name(dt):>8} m={m:<3} k={k:<5} "
              f"n={n:<6} trans_b={c['trans_b']:d} {c['kind']:>8}/{c['act']}: "
              f"err {err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f}  library "
              f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
              f"{n_bytes / ms / 1e6:.1f} GB/s")
        if m == 2 and c["per_step"]:
            steps[c["model"]].add(c["per_step"], ms, plain_ms, lib_ms, bound,
                                  n_bytes, n_ops)
    rows = {}
    for model, step in steps.items():
        row = rows[model] = step.row("bfloat16")
        print(f"[k1] one full-width {model} decode step (M=2, "
              f"{step.launches} launches): kernel {row['ms']:.3f} ms, plain "
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

            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = _check_close(torch, f"K1 int8 {name} m={m}", got, ref, tol)
            step.max_abs_err = max(step.max_abs_err, err)
            n_bytes = m * k + k * n + 2 * m * n * (1 + len(extras)) + 4
            n_ops = 2 * m * n * k
            bound, bound_by = _bound_ms(n_bytes, n_ops, "int8")
            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
            print(f"[k1-int8] {name:>7} m={m:<3} k={k:<5} n={n:<6} "
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
    timed alone on a cold L2, beside the plain version, SDPA with the same
    mask (K/V repeated for GQA beforehand, not timed) and the bound."""
    from repro_torch.kernels.flash_attention import (
        _attention_mask, flash_attention, flash_attention_plain,
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
        mask = _attention_mask(tq, tk, causal, window, q.device)

        def kern():
            return flash_attention(q, k, v, **kw)

        def plain():
            return flash_attention_plain(q, k, v, **kw)

        def library():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
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
        print(f"[k4] {name:>20} {dt:>8} B={b} H={h} Hkv={hkv} D={d} "
              f"tq={tq} tk={tk} causal={causal:d} window={window}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library (SDPA) "
              f"{lib_ms:.4f}  bound {bound:.4f} ({bound_by})  "
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

                got, ref = kern(), plain()
                torch.cuda.synchronize()
                err = _check_close(torch, f"grouped K1 {dt_name} {name} "
                                   f"m={m}", got, ref, TOL["float32"])
                step.max_abs_err = max(step.max_abs_err, err)
                n_bytes = (g * (m * k + k * n) * a.element_size()
                           + 4 * g * m * n * (1 + len(extras)) + 4)
                n_ops = 2 * g * m * n * k
                bound, bound_by = _bound_ms(n_bytes, n_ops, dt_name)
                ms, plain_ms, lib_ms = timer(kern), timer(plain), \
                    timer(library)
                print(f"[k1-grouped] {dt_name:>8} {name:>4} G={g} m={m:<3} "
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
    from repro_torch.packing.pack import pack_operand
    return dict(k1=mpgemm, k1g=mpgemm_grouped, k2=mpgemm_packed,
                k2g=mpgemm_packed_grouped, k3=mpgemm_sparse,
                k3g=mpgemm_sparse_grouped, k4=flash_attention,
                k5=paged_flash_attention, k6=pack_operand)


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
    want["k4"] = 0
    want["k5"] = n_layers * n_steps
    want["k6"] = (n_layers * (4 + (3 if moe else dense_2d)) + int(head_done)
                  if pack or sparse else 0)
    return want, per_step


def phase_serve(torch, *, label, arch="phi3-mini-3.8b", policy="bf16",
                pack=False, pack_format=None, n_layers=None, sparsity=0.0,
                sparsity_method="magnitude"):
    """Serve 4 requests through the engine; every launch count of the run
    (packing or sparsifying at load included) must be what the path
    needs."""
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
    model = build_model(cfg, policy=policy, device="cuda")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
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
        how = (f", tile-sparse {sparsity_method} at sparsity {sparsity} "
               f"(tile density {sparse_param_density(params):.4f}, "
               f"{SPARSE_BLOCKS[0]} x {SPARSE_BLOCKS[1]} tiles)")
    kind = "sparse" if sparsity else "packed"
    peak = torch.cuda.max_memory_allocated() / 1e9
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
    if not all(finite):
        raise AssertionError("non-finite logits during serving")
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 steps=n_steps, payload_gb=payload / 1e9,
                 decode_step_ms=1e3 * float(np.median(decode)),
                 ttft_ms=1e3 * float(np.median(prefill)), **counts)
    serve["logit_err"] = _kernel_vs_plain_step(torch, model, params, label)
    args = _decode_args(torch, model)

    def step():
        return model.paged_step(params, *args)

    serve["enqueue_ms"], serve["step_ms"] = _decode_step_times(torch, step)
    print(f"[serve:{label}] one two-row decode step: the host enqueues it "
          f"in {serve['enqueue_ms']:.2f} ms, the device is done after "
          f"{serve['step_ms']:.2f} ms")
    _profile_decode_step(torch, step, label, serve["step_ms"])
    return serve


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@contextlib.contextmanager
def _plain_versions(enabled=True):
    """Within the block, every GEMM and attention wrapper the model calls is
    its plain version (the plain versions are rank-generic: they stand in
    for the 2-D and the grouped GEMM wrappers alike)."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.kernels.flash_attention import (
        flash_attention_plain, paged_flash_attention_plain,
    )
    from repro_torch.kernels.mpgemm import (
        mpgemm_packed_plain, mpgemm_plain, mpgemm_sparse_plain,
    )
    from repro_torch.models import attention as attn_mod
    from repro_torch.packing.layout import PackedOperand
    from repro_torch.sparse import TileSparseOperand

    if not enabled:
        yield
        return

    def plain_gemm(a, b, *, spec, out_dtype=None, c=None, **kw):
        out_dtype = out_dtype or spec.out_dtype
        if isinstance(b, PackedOperand):
            return mpgemm_packed_plain(a, b, out_dtype=out_dtype, **kw)
        if isinstance(b, TileSparseOperand):
            return mpgemm_sparse_plain(a, b, out_dtype=out_dtype, **kw)
        return mpgemm_plain(a, b, trans_b=spec.trans_b, out_dtype=out_dtype,
                            **kw)

    saved = (gemm_mod.mpgemm, gemm_mod.mpgemm_grouped,
             attn_mod.paged_flash_attention, attn_mod.flash_attention)
    gemm_mod.mpgemm = gemm_mod.mpgemm_grouped = plain_gemm
    attn_mod.paged_flash_attention = paged_flash_attention_plain
    attn_mod.flash_attention = flash_attention_plain
    try:
        yield
    finally:
        (gemm_mod.mpgemm, gemm_mod.mpgemm_grouped,
         attn_mod.paged_flash_attention, attn_mod.flash_attention) = saved


def _kernel_vs_plain_step(torch, model, params, label):
    """One full-width mixed step (a 16-token prefill chunk beside a decode
    row) through the kernels and through the plain versions, on copies of
    the same pools."""
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

    with _plain_versions():
        lp, _ = model.paged_step(params, tokens, pools_p, bt, qs, nv)
    lk, lp = lk.float()[:, :vocab], lp.float()[:, :vocab]
    diff = (lk - lp).abs()
    err, scale = diff.max().item(), lp.abs().max().item()
    top_agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    rel = LOGIT_REL_TOL["int8" if model.policy == "int8" else "bf16"]
    print(f"[serve:{label}] one full-width mixed step, kernels vs plain "
          f"versions: max |logit diff| {err:.3e}, mean "
          f"{diff.mean().item():.3e} (bound {rel} x max |logit| = "
          f"{rel * scale:.3e}), argmax agreement {top_agree:.2f}")
    if not (err <= rel * scale and torch.isfinite(lk).all()):
        raise AssertionError(f"kernel and plain logits differ by {err:.3e}")
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
                 ("mpgemm_kernel", "K1"), ("paged_flash_kernel", "K5"),
                 ("flash_kernel", "K4"), ("pack_kernel", "K6"))


def _profile_decode_step(torch, step, label, step_ms):
    """One two-row decode step (``step()``) under ``torch.profiler``: the
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
        with record_function("decode_step"):
            step()
        torch.cuda.synchronize()
    events = prof.events()
    step = next(e for e in events if e.name == "decode_step"
                and e.device_type == DeviceType.CPU)
    t0, t_host = step.time_range.start, step.time_range.end
    # Kernels, copies and sets; the trace also mirrors the "decode_step"
    # annotation on the device, which is no work of the device.
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != "decode_step" and e.time_range.end >= t0),
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
    print(f"[profile:{label}] one two-row decode step under torch.profiler: "
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
    for fn in counters.values():
        fn.launches = 0
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

def main():
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
    del timer
    serves = {}
    granite = "granite-moe-1b-a400m"
    for label, kw in (
            ("bf16", dict()),
            ("int4", dict(pack=True, pack_format="int4")),
            ("int8", dict(policy="int8", pack=True)),
            ("int8-dense", dict(policy="int8", n_layers=4)),
            ("phi3-sparse-bf16", dict(sparsity=0.5)),
            ("granite-bf16", dict(arch=granite)),
            ("granite-int4", dict(arch=granite, pack=True,
                                  pack_format="int4")),
            ("granite-int8", dict(arch=granite, policy="int8", pack=True)),
            ("granite-int8-dense", dict(arch=granite, policy="int8",
                                        n_layers=4)),
            ("granite-sparse-int8", dict(arch=granite, policy="int8",
                                         sparsity=0.5,
                                         sparsity_method="nm"))):
        serves[label] = phase_serve(torch, label=label, **kw)
        gc.collect()              # free each path's weights before the next
        torch.cuda.empty_cache()
    waves = {}
    for label, arch in (("whisper", "whisper-medium"),
                        ("phi3", "phi3-mini-3.8b")):
        waves[label] = phase_wave_serve(torch, label=label, arch=arch)
        gc.collect()
        torch.cuda.empty_cache()

    def row(name, source, replaces, launches, numbers):
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=launches,
                    **{k: numbers[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")},
                    library_ms=numbers.get("library_ms"))

    mp = "src/repro/kernels/mpgemm.py"
    fa = "src/repro/kernels/flash_attention.py:154"
    fa4 = "src/repro/kernels/flash_attention.py:31"
    kernels = [
        row("K1 mpgemm (dense 2-D MPGEMM, bf16, fused epilogue)",
            "mpgemm.cu", f"{mp}:232", serves["bf16"]["k1"], k1["phi3"]),
        row("K1 mpgemm int8 (dense int8 policy, int32 sum, device scale)",
            "mpgemm.cu", f"{mp}:232", serves["int8-dense"]["k1"],
            k1_int8["phi3"]),
        row("K2 mpgemm_packed (int4 payload, bf16 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int4"]["k2"], k2[("phi3", ("bf16", "int4"))]),
        row("K2 mpgemm_packed (int8 payload, int8 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int8"]["k2"], k2[("phi3", ("int8", "int8"))]),
        row("K5 paged_flash (paged flash attention)", "paged_flash.cu", fa,
            serves["bf16"]["k5"], k5["phi3"]),
        row("K1 mpgemm at granite's 2-D shapes (bf16 attention, f32 router, "
            "tied head as B^T)", "mpgemm.cu", f"{mp}:232",
            serves["granite-bf16"]["k1"], k1["granite"]),
        row("K1 mpgemm int8 at granite's 2-D shapes (attention, tied head; "
            "the launches include the f32 routers)", "mpgemm.cu", f"{mp}:232",
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
        row("K6 pack (tile packing, int4 payload, whole model)", "pack.cu",
            "src/repro/packing/pack.py:221", serves["int4"]["k6"],
            dict(k6["int4"], library_ms=None)),
        row("K1 mpgemm_grouped (granite expert GEMMs, bf16 A, f32 out, "
            "fused SwiGLU gate)", "mpgemm.cu", f"{mp}:812",
            serves["granite-bf16"]["k1g"], k1g["bfloat16"]),
        row("K1 mpgemm_grouped int8 (granite expert GEMMs, int32 sum, "
            "device scale)", "mpgemm.cu", f"{mp}:812",
            serves["granite-int8-dense"]["k1g"], k1g["int8"]),
        row("K2 mpgemm_packed_grouped (granite experts, int4 payload, bf16 "
            "A)", "mpgemm_packed.cu", f"{mp}:250",
            serves["granite-int4"]["k2g"], k2g[("bf16", "int4")]),
        row("K2 mpgemm_packed_grouped (granite experts, int8 payload, int8 "
            "A)", "mpgemm_packed.cu", f"{mp}:250",
            serves["granite-int8"]["k2g"], k2g[("int8", "int8")]),
        row("K6 pack (granite: 96 2-D weights and 72 grouped expert stacks, "
            "int4 payload)", "pack.cu", "src/repro/packing/pack.py:280",
            serves["granite-int4"]["k6"],
            dict(k6g["int4"], library_ms=None)),
        row("K4 flash_attention (whisper-medium wave prefill: 24 encoder "
            "1500x1500, 24 causal, 24 cross 32x1500)", "flash_attention.cu",
            fa4, waves["whisper"]["k4"], k4["whisper-prefill"]),
        row("K4 flash_attention (whisper-medium decode step: 24 cross "
            "1x1500)", "flash_attention.cu", fa4, waves["whisper"]["k4"],
            k4["whisper-decode"]),
        row("K4 flash_attention (phi3-mini wave prefill: 32 causal, D 96)",
            "flash_attention.cu", fa4, waves["phi3"]["k4"],
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
