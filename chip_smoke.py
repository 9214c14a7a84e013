#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. the card's name and power limit; build every kernel from ``csrc/`` with
   nvcc (one process per source, in parallel) and print the build seconds;
2. K1 (``kernels/csrc/mpgemm.cu``) against its plain version at the
   full-width phi3-mini GEMM shapes (decode M = 2 and chunked prefill
   M = 32), a ragged edge case and an f32 case; then K1's int8 variant
   (int8 operands, exact int32 sum, device scale) at the same shapes;
3. K5 (``kernels/csrc/paged_flash.cu``) against its plain version at
   phi3-mini's attention shapes (decode and 16-token chunked prefill) and
   at a GQA + sliding-window shape, with ragged lengths, dead block-table
   slots over a NaN-filled scratch page and one idle row;
4. K6 (``kernels/csrc/pack.cu``) packing every full-width phi3-mini weight
   shape and a ragged ``trans_w`` one into bf16, int8, int4 and fp8
   payloads: payload and scales byte-equal to its plain version;
5. K2 (``kernels/csrc/mpgemm_packed.cu``) at the same shapes, M = 2 and 32,
   for every payload under the bf16 policy (bf16 A) and the int8 and int4
   payloads under the int8 policy (int8 A and its scale), against its plain
   version;
6. full-width phi3-mini-3.8b (random weights from a seed) serving 4
   requests through ``repro_torch.serve.engine.ServeEngine``, first dense
   bf16 (225 K1 and 32 K5 launches per ``paged_step``), then packed from
   the f32 draw by K6, with int4 payloads under bf16 and with int8 payloads
   under the int8 policy (225 K2, 32 K5 and 0 K1 launches per step), then
   dense under the int8 policy with the depth cut to 4 layers (29 int8 K1
   launches per step).  Every logit is finite, and for each full-depth path
   one full-width step through the kernels agrees with the same step
   through the plain versions;
7. one JSON line with every ported kernel's launches, error and times;
8. the card line, then ``{"ok": true, "device": {...}}`` as the last line.

Times come from CUDA events around single launches, each after a 256 MiB
write that evicts the 50 MB L2 (serving reads every weight cold once per
step).  ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations /
peak (989 TFLOP/s bf16, 67 TFLOP/s f32, 1979 TOP/s int8), counting each
input read once and each output written once.  ``library_ms`` times one
PyTorch call of the same function as a yardstick; the port never calls it.
"""
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
                              bias=False, per_step=per_step))
    cases.append(dict(name="edge", m=37, k=129, n=100, kind="linear",
                      act="relu", dtype=bf16, trans_b=True, bias=True,
                      per_step=0))
    cases.append(dict(name="edge-small", m=5, k=200, n=77, kind="residual",
                      act="gelu", dtype=bf16, trans_b=False, bias=True,
                      per_step=0))
    cases.append(dict(name="f32", m=32, k=3072, n=3072, kind="gated",
                      act="silu", dtype=f32, trans_b=False, bias=True,
                      per_step=0))

    step = StepSum()
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
        step.max_abs_err = max(step.max_abs_err, err)
        esz = a.element_size()
        n_bytes = (m * k + k * n + m * n) * esz + m * n * esz * len(extras) \
            + (4 * n if bias is not None else 0)
        n_ops = 2 * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        print(f"[k1] {c['name']:>10} {_dtype_name(dt):>8} m={m:<3} k={k:<5} "
              f"n={n:<6} {c['kind']:>8}/{c['act']}: err {err:.2e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.4f} ({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s")
        if m == 2 and c["per_step"]:
            step.add(c["per_step"], ms, plain_ms, lib_ms, bound, n_bytes,
                     n_ops)
    row = step.row("bfloat16")
    print(f"[k1] one full-width decode step (M=2, {step.launches} "
          f"launches): kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms, "
          f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return row


def phase_k1_int8(torch, timer):
    """K1's int8 variant (the dense int8 policy): int8 operands, an exact
    int32 sum, the scale read from device memory."""
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    step = StepSum()
    for m in (2, 32):
        for name, k, n, kind, act, per_step in MAIN_SHAPES:
            a = torch.randint(-127, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
            # sx * sw of unit-variance data: outputs of order 1.
            scale = torch.full((), 3.0 / (127.0 * 127.0 * k ** 0.5),
                               device="cuda")
            extras = () if kind == "linear" else (
                torch.randn(m, n, generator=gen, device="cuda").to(bf16),)
            ep = EpilogueSpec(kind=kind, activation=act)
            a_lib, w_lib = a.to(bf16), w.to(bf16)   # exact: |q| <= 127

            def kern():
                return mpgemm(a, w, scale=scale, extras=extras, epilogue=ep,
                              out_dtype=bf16)

            def plain():
                return mpgemm_plain(a, w, scale=scale, extras=extras,
                                    epilogue=ep, out_dtype=bf16)

            def library():
                acc = torch.matmul(a_lib, w_lib)
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
            print(f"[k1-int8] {name:>5} m={m:<3} k={k:<5} n={n:<6} "
                  f"{kind:>8}/{act}: err {err:.2e}  kernel {ms:.4f} ms  "
                  f"plain {plain_ms:.4f}  library {lib_ms:.4f}  bound "
                  f"{bound:.4f} ({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s")
            if m == 2:
                step.add(per_step, ms, plain_ms, lib_ms, bound, n_bytes,
                         n_ops)
    row = step.row("int8")
    print(f"[k1-int8] one full-width decode step (M=2, {step.launches} "
          f"launches): kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} ms "
          f"(bf16 matmul of the int8 values), bound {row['bound_ms']:.3f} "
          f"ms ({row['bound_by']})")
    return row


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
        # phi3-mini attention as phase 4 serves it: MHA, D = 96, page 16,
        # a block table 4 pages wide (max_len 64); request 2 is idle, and
        # in the prefill chunk request 1 has 7 dead rows past its length.
        dict(name="phi3-decode", h=32, hkv=32, d=96, ps=16, w=4, tq=1,
             lengths=[45, 30, 0], window=None, dtype=bf16, main=True),
        dict(name="phi3-prefill16", h=32, hkv=32, d=96, ps=16, w=4, tq=16,
             lengths=[48, 9, 0], window=None, dtype=bf16, main=False),
        # GQA 4:1, D = 120 (not a multiple of 16), window 64, ~200 context
        dict(name="gqa-window-decode", h=32, hkv=8, d=120, ps=16, w=16,
             tq=1, lengths=[201, 64, 0, 9], window=64, dtype=bf16,
             main=False),
        dict(name="gqa-window-prefill16", h=32, hkv=8, d=120, ps=16, w=16,
             tq=16, lengths=[200, 70, 0, 16], window=64, dtype=bf16,
             main=False),
        dict(name="f32-gqa-prefill16", h=8, hkv=2, d=64, ps=16, w=8, tq=16,
             lengths=[40, 100, 0, 3], window=None, dtype=torch.float32,
             main=False),
    ]
    rows, main, max_err = [], None, 0.0
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
            main = row
        print(f"[k5] {c['name']:>20} H={c['h']} Hkv={c['hkv']} D={c['d']} "
              f"tq={tq} lengths={c['lengths']} window={c['window']}: err "
              f"{err:.2e} (rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.5f} ({bound_by})")
    # Per full-width decode step: 32 launches (one per layer) of the decode
    # case, as the K1 numbers are one decode step's 225 launches.
    step = {k: 32 * main[k] for k in ("ms", "plain_ms", "library_ms",
                                      "bound_ms")}
    step.update(bound_by=main["bound_by"], max_abs_err=max_err)
    print(f"[k5] one full-width decode step (32 launches of phi3-decode): "
          f"kernel {step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, "
          f"library {step['library_ms']:.3f} ms, bound "
          f"{step['bound_ms']:.4f} ms ({step['bound_by']})")
    return step, rows


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


def phase_k2(torch, timer):
    from repro_torch.core.gemm_spec import EpilogueSpec, apply_epilogue
    from repro_torch.core.policy import quantize_per_tensor
    from repro_torch.kernels.mpgemm import mpgemm_packed, \
        mpgemm_packed_plain
    from repro_torch.packing.pack import pack_operand, unpack_reference
    from repro_torch.packing.params import default_blocks

    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16, tol = torch.bfloat16, TOL["bfloat16"]
    steps = {c: StepSum() for c in K2_COMBOS}
    for name, k, n, kind, act, per_step in MAIN_SHAPES:
        w = torch.randn(k, n, generator=gen, device="cuda") * \
            (2.0 / (k + n)) ** 0.5
        packed = {fmt: pack_operand(w, default_blocks(k, n), dtype=fmt)
                  for fmt in PAYLOADS}
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
            for policy, fmt in K2_COMBOS:
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
                st = steps[(policy, fmt)]
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
    for (policy, fmt), st in steps.items():
        row = rows[(policy, fmt)] = st.row(
            "int8" if policy == "int8" else "bfloat16")
        print(f"[k2] one full-width decode step, {policy} A x {fmt} (M=2, "
              f"{st.launches} launches): kernel {row['ms']:.3f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library {row['library_ms']:.3f} "
              f"ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    return rows


# ------------------------------------------------------------------ phase 6

def _counters():
    from repro_torch.kernels.flash_attention import paged_flash_attention
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_packed
    from repro_torch.packing.pack import pack_operand
    return dict(k1=mpgemm, k2=mpgemm_packed, k5=paged_flash_attention,
                k6=pack_operand)


def phase_serve(torch, *, label, policy="bf16", pack=False,
                pack_format=None, n_layers=None):
    """Serve 4 requests through the engine; every launch count of the run
    (packing at load included) must be what the path needs."""
    import dataclasses

    from repro_torch.configs import base as cb
    from repro_torch.models.transformer import build_model
    from repro_torch.packing.params import packed_param_bytes
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = cb.get("phi3-mini-3.8b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    n_layers = cfg.n_layers
    gemms = 7 * n_layers + 1
    model = build_model(cfg, policy=policy, device="cuda")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        pack=pack, pack_format=pack_format)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    dense = sum(t.numel() * t.element_size() for t in _leaves(params)
                if isinstance(t, torch.Tensor))
    payload = packed_param_bytes(params)
    packing = (f", packed {pack_format or 'at the policy dtype'}" if pack
               else "")
    print(f"[serve:{label}] {cfg.name}, {n_layers} layers, policy {policy}"
          f"{packing}: {payload / 1e9:.3f} GB packed payload + "
          f"{dense / 1e9:.3f} GB dense tensors, initialised on the card in "
          f"{t_init:.3f} s")

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
    n_tok = sum(len(v) for v in out.values())
    decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
    prefill = [s.wall_s for s in eng.step_telemetry if s.phase != "decode"]
    print(f"[serve:{label}] 4 requests (prompts "
          f"{[len(r.prompt) for r in reqs]}), {n_tok} tokens in {wall:.3f} s "
          f"= {n_tok / wall:.2f} tok/s; {n_steps} paged_step calls "
          f"({len(prefill)} with prefill, median "
          f"{1e3 * np.median(prefill):.2f} ms); median decode step "
          f"{1e3 * np.median(decode):.2f} ms")
    print(f"[serve:{label}] launches: K1 {counts['k1']}, K2 {counts['k2']}, "
          f"K5 {counts['k5']} ({n_steps} steps x {gemms} GEMMs and "
          f"{n_layers} attention layers), K6 {counts['k6']} at load")
    # eos (id 1) may end a request early; every request must finish.
    if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
        raise AssertionError(f"served {sorted(out)} of 4 requests")
    want = dict(k1=0 if pack else gemms * n_steps,
                k2=gemms * n_steps if pack else 0,
                k5=n_layers * n_steps, k6=gemms if pack else 0)
    if counts != want:
        raise AssertionError(f"launch counts {counts}, want {want}")
    if not all(finite):
        raise AssertionError("non-finite logits during serving")
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 steps=n_steps, payload_gb=payload / 1e9,
                 decode_step_ms=1e3 * float(np.median(decode)), **counts)
    serve["logit_err"] = _kernel_vs_plain_step(torch, model, params, label)
    serve["enqueue_ms"], serve["step_ms"] = _decode_step_times(torch, model,
                                                               params)
    print(f"[serve:{label}] one two-row decode step: the host enqueues it "
          f"in {serve['enqueue_ms']:.2f} ms, the device is done after "
          f"{serve['step_ms']:.2f} ms")
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


def _kernel_vs_plain_step(torch, model, params, label):
    """One full-width mixed step (a 16-token prefill chunk beside a decode
    row) through the kernels and through the plain versions, on copies of
    the same pools."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.kernels.flash_attention import \
        paged_flash_attention_plain
    from repro_torch.kernels.mpgemm import mpgemm_packed_plain, mpgemm_plain
    from repro_torch.models import attention as attn_mod
    from repro_torch.packing.layout import PackedOperand

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

    def plain_gemm(a, b, *, spec, out_dtype=None, c=None, **kw):
        out_dtype = out_dtype or spec.out_dtype
        if isinstance(b, PackedOperand):
            return mpgemm_packed_plain(a, b, out_dtype=out_dtype, **kw)
        return mpgemm_plain(a, b, trans_b=spec.trans_b, out_dtype=out_dtype,
                            **kw)

    saved = (gemm_mod.mpgemm, attn_mod.paged_flash_attention)
    gemm_mod.mpgemm = plain_gemm
    attn_mod.paged_flash_attention = paged_flash_attention_plain
    try:
        lp, _ = model.paged_step(params, tokens, pools_p, bt, qs, nv)
    finally:
        gemm_mod.mpgemm, attn_mod.paged_flash_attention = saved
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


def _decode_step_times(torch, model, params, steps=5):
    """Median host time to enqueue one two-row decode step, and the same
    step's time until the device is done: equal when the host bounds it."""
    ps, w = 16, 4
    caches = model.init_paged_caches(1 + 2 * w, ps)
    i32 = dict(dtype=torch.int32, device="cuda")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], **i32)
    tokens = torch.tensor([[5], [7]], **i32)
    args = (tokens, caches, bt, torch.tensor([40, 20], **i32),
            torch.tensor([1, 1], **i32))
    enqueue, total = [], []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.paged_step(params, *args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(enqueue[1:])), \
        1e3 * float(np.median(total[1:]))


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
    k6 = phase_k6(torch, timer)
    k2 = phase_k2(torch, timer)
    del timer
    serves = {}
    for label, kw in (
            ("bf16", dict()),
            ("int4", dict(pack=True, pack_format="int4")),
            ("int8", dict(policy="int8", pack=True)),
            ("int8-dense", dict(policy="int8", n_layers=4))):
        serves[label] = phase_serve(torch, label=label, **kw)
        gc.collect()              # free each path's weights before the next
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
    kernels = [
        row("K1 mpgemm (dense 2-D MPGEMM, bf16, fused epilogue)",
            "mpgemm.cu", f"{mp}:232", serves["bf16"]["k1"], k1),
        row("K1 mpgemm int8 (dense int8 policy, int32 sum, device scale)",
            "mpgemm.cu", f"{mp}:232", serves["int8-dense"]["k1"], k1_int8),
        row("K2 mpgemm_packed (int4 payload, bf16 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int4"]["k2"], k2[("bf16", "int4")]),
        row("K2 mpgemm_packed (int8 payload, int8 A)", "mpgemm_packed.cu",
            f"{mp}:106", serves["int8"]["k2"], k2[("int8", "int8")]),
        row("K5 paged_flash (paged flash attention)", "paged_flash.cu",
            "src/repro/kernels/flash_attention.py:154", serves["bf16"]["k5"],
            k5),
        row("K6 pack (tile packing, int4 payload, whole model)", "pack.cu",
            "src/repro/packing/pack.py:221", serves["int4"]["k6"],
            dict(k6["int4"], library_ms=None)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
