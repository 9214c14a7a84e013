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
   M = 32), a ragged edge case and an f32 case;
3. K5 (``kernels/csrc/paged_flash.cu``) against its plain version at
   phi3-mini's attention shapes (decode and 16-token chunked prefill) and
   at a GQA + sliding-window shape, with ragged lengths, dead block-table
   slots over a NaN-filled scratch page and one idle row;
4. full-width phi3-mini-3.8b (random weights from a seed) serving 4
   requests through ``repro_torch.serve.engine.ServeEngine``; the launch
   counts must be 225 (K1) and 32 (K5) per ``paged_step``, every logit
   finite, and one full-width step through the kernels must agree with the
   same step through the plain versions;
5. one JSON line with every ported kernel's launches, error and times;
6. the card line, then ``{"ok": true, "device": {...}}`` as the last line.

Times come from CUDA events around single launches, each after a 256 MiB
write that evicts the 50 MB L2 (serving reads every weight cold once per
step).  ``bound_ms`` is the larger of bytes / 3.35 TB/s and operations /
peak (989 TFLOP/s bf16, 67 TFLOP/s f32), counting each input read once and
each output written once.  ``library_ms`` times one PyTorch call of the
same function as a yardstick; the port never calls it.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
FLUSH_BYTES = 256 << 20
ITERS = 10

# Tolerances, kernel against plain version on the same card and inputs:
# bf16 outputs may differ by one bf16 rounding (2**-8 relative) because the
# f32 sums run in another order; f32 outputs by f32 summation order only.
TOL = {"bfloat16": dict(rtol=1.6e-2, atol=1.6e-2),
       "float32": dict(rtol=1e-4, atol=1e-4)}
# Full-width bf16 logits after 32 layers: each GEMM output and the residual
# stream are rounded to bf16, and a rounding that lands on the other side in
# one layer moves the hidden state of every later one.  A logit's error is
# that hidden-state error times the head, so it scales with the logits'
# range, not with each logit: the bound is 2 % of the largest |logit|, about
# five bf16 ulps (2**-8 relative each) at that magnitude.
LOGIT_REL_TOL = 2e-2


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


# ------------------------------------------------------------------ phase 2

def phase_k1(torch, timer):
    from repro_torch.core.gemm_spec import EpilogueSpec, GemmSpec, \
        apply_epilogue
    from repro_torch.kernels.mpgemm import mpgemm, mpgemm_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    main_shapes = [  # (name, K, N, kind, activation, launches per step)
        ("qkvo", 3072, 3072, "linear", None, 4 * 32),
        ("up", 3072, 8192, "linear", None, 32),
        ("gate", 3072, 8192, "gated", "silu", 32),
        ("down", 8192, 3072, "residual", None, 32),
        ("head", 3072, 32128, "linear", None, 1),
    ]
    cases = []
    for m in (2, 32):
        for name, k, n, kind, act, per_step in main_shapes:
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

    rows, step = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                          launches=0, bytes=0, ops=0)
    max_err = 0.0
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
        err = (got.float() - ref.float()).abs().max().item()
        tol = TOL[_dtype_name(dt)]
        ok = torch.allclose(got.float(), ref.float(), **tol)
        if not ok or not torch.isfinite(got.float()).all():
            raise AssertionError(
                f"K1 {c['name']} m={m} k={k} n={n}: max |kernel - plain| = "
                f"{err:.3e} beyond rtol={tol['rtol']}, atol={tol['atol']}")
        max_err = max(max_err, err)
        esz = a.element_size()
        n_bytes = (m * k + k * n + m * n) * esz + m * n * esz * len(extras) \
            + (4 * n if bias is not None else 0)
        n_ops = 2 * m * n * k
        bound, bound_by = _bound_ms(n_bytes, n_ops, _dtype_name(dt))
        ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(library)
        rows.append(dict(case=c["name"], m=m, k=k, n=n, kind=c["kind"],
                         act=c["act"], dtype=_dtype_name(dt),
                         trans_b=c["trans_b"], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound, bound_by=bound_by,
                         gbps=n_bytes / ms / 1e6))
        print(f"[k1] {c['name']:>10} {_dtype_name(dt):>8} m={m:<3} k={k:<5} "
              f"n={n:<6} {c['kind']:>8}/{c['act']}: err {err:.2e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']})  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f}  library {lib_ms:.4f}  "
              f"bound {bound:.4f} ({bound_by})  {n_bytes / ms / 1e6:.1f} GB/s")
        if m == 2 and c["per_step"]:
            p = c["per_step"]
            step["ms"] += p * ms
            step["plain_ms"] += p * plain_ms
            step["library_ms"] += p * lib_ms
            step["bound_ms"] += p * bound
            step["launches"] += p
            step["bytes"] += p * n_bytes
            step["ops"] += p * n_ops
    _, step["bound_by"] = _bound_ms(step["bytes"], step["ops"], "bfloat16")
    step["max_abs_err"] = max_err
    print(f"[k1] one full-width decode step (M=2, {step['launches']} "
          f"launches): kernel {step['ms']:.3f} ms, plain "
          f"{step['plain_ms']:.3f} ms, library {step['library_ms']:.3f} ms, "
          f"bound {step['bound_ms']:.3f} ms ({step['bound_by']})")
    return step, rows


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

def phase_serve(torch):
    from repro_torch.configs import base as cb
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.flash_attention import paged_flash_attention
    from repro_torch.kernels.mpgemm import mpgemm
    from repro_torch.models.transformer import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = cb.get("phi3-mini-3.8b")
    model = build_model(cfg, policy="bf16", device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"(vocab padded to {model.vocab_padded}) initialised on the card "
          f"in {time.perf_counter() - t0:.3f} s")

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
    mpgemm.launches = 0
    paged_flash_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k5 = mpgemm.launches, paged_flash_attention.launches
    n_steps = len(step_calls)
    n_tok = sum(len(v) for v in out.values())
    decode = [s.wall_s for s in eng.step_telemetry if s.phase == "decode"]
    prefill = [s.wall_s for s in eng.step_telemetry if s.phase != "decode"]
    print(f"[serve] 4 requests (prompts {[len(r.prompt) for r in reqs]}), "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tok/s; "
          f"{n_steps} paged_step calls ({len(prefill)} with prefill, "
          f"median {1e3 * np.median(prefill):.2f} ms); median decode step "
          f"{1e3 * np.median(decode):.2f} ms")
    print(f"[serve] launches: K1 {k1} (= 225 x {k1 / max(n_steps, 1):.2f}), "
          f"K5 {k5} (= 32 x {k5 / max(n_steps, 1):.2f})")
    # eos (id 1) may end a request early; every request must finish.
    if sorted(out) != [0, 1, 2, 3] or not all(out.values()):
        raise AssertionError(f"served {sorted(out)} of 4 requests")
    if k1 != 225 * n_steps or k5 != 32 * n_steps:
        raise AssertionError(f"launch counts K1={k1}, K5={k5} for "
                             f"{n_steps} steps (want 225 and 32 per step)")
    if not all(finite):
        raise AssertionError("non-finite logits during serving")
    model.paged_step = inner
    serve = dict(tokens=n_tok, wall_s=wall, tok_per_s=n_tok / wall,
                 steps=n_steps, k1=k1, k5=k5,
                 decode_step_ms=1e3 * float(np.median(decode)))
    serve["logit_err"] = _kernel_vs_plain_step(torch, model, params)
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


def _kernel_vs_plain_step(torch, model, params):
    """One full-width mixed step (a 16-token prefill chunk beside a decode
    row) through the kernels and through the plain versions, on copies of
    the same pools."""
    from repro_torch.core import gemm as gemm_mod
    from repro_torch.kernels.flash_attention import \
        paged_flash_attention_plain
    from repro_torch.kernels.mpgemm import mpgemm_plain
    from repro_torch.models import attention as attn_mod

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

    def plain_gemm(a, b, *, spec, out_dtype=None, **kw):
        kw.pop("c", None)
        kw.pop("scale", None)
        return mpgemm_plain(a, b, trans_b=spec.trans_b,
                            out_dtype=out_dtype or spec.out_dtype, **kw)

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
    print(f"[serve] one full-width mixed step, kernels vs plain versions: "
          f"max |logit diff| {err:.3e}, mean {diff.mean().item():.3e} "
          f"(bound {LOGIT_REL_TOL} x max |logit| = "
          f"{LOGIT_REL_TOL * scale:.3e}), argmax agreement {top_agree:.2f}")
    if not (err <= LOGIT_REL_TOL * scale and torch.isfinite(lk).all()):
        raise AssertionError(f"kernel and plain logits differ by {err:.3e}")
    return err


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
    print(f"[build] {time.perf_counter() - t0:.1f} s wall for "
          f"{built or 'nothing (up to date)'} (one nvcc per source, in "
          f"parallel)")
    for name in _build.KERNELS:   # ptxas -v, once per distinct line
        lines = (_build.build_log(name) or "").splitlines()
        for line in dict.fromkeys(ln.strip() for ln in lines
                                  if "registers" in ln or "spill" in ln):
            print(f"[build] {name}: {line}")

    timer = Timer(torch)
    k1, _ = phase_k1(torch, timer)
    k5, _ = phase_k5(torch, timer)
    serve = phase_serve(torch)

    kernels = [
        dict(name="K1 mpgemm (dense 2-D MPGEMM, fused epilogue)",
             route="cuda", source="src/repro_torch/kernels/csrc/mpgemm.cu",
             replaces="src/repro/kernels/mpgemm.py:232",
             launches=serve["k1"], max_abs_err=k1["max_abs_err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=k1["library_ms"]),
        dict(name="K5 paged_flash (paged flash attention)", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_flash.cu",
             replaces="src/repro/kernels/flash_attention.py:154",
             launches=serve["k5"], max_abs_err=k5["max_abs_err"],
             ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
             bound_by=k5["bound_by"], library_ms=k5["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
