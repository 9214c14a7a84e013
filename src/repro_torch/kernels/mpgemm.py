"""K1 and K2 wrappers: the 2-D MPGEMM with a fused epilogue (port of
``repro.kernels.mpgemm.mpgemm_pallas_spec``), dense B (K1) or pre-packed B
(K2).

:func:`mpgemm` is polymorphic in ``b``, as the reference is: a dense tensor
goes to K1, a :class:`~repro_torch.packing.layout.PackedOperand` to
:func:`mpgemm_packed` (K2).  Each dispatches by the device of its operands:
a CPU tensor runs the plain version, a CUDA tensor launches the
hand-written kernel (``csrc/mpgemm.cu``, ``csrc/mpgemm_packed.cu``, built
on first use by ``_build.py``).  Variants the kernels do not take yet --
``trans_a``, ``beta·C``, grouped and tile-sparse B -- raise
``NotImplementedError`` on every device, so the CPU path never offers what
the card cannot run.

K1 takes bf16 or f32 operands summed in f32, or int8 operands summed
exactly in int32 (the int8 policy).  ``scale`` is a one-element f32 tensor
on the operands' device (the int8 policy's ``sx · sw``); the kernels read
it in their epilogue, so no GEMM waits on the host.

``mpgemm.launches`` and ``mpgemm_packed.launches`` count kernel launches
(never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.core.gemm_spec import (
    LINEAR, EpilogueSpec, GemmSpec, apply_epilogue, get_epilogue,
)
from repro_torch.kernels import _build
from repro_torch.packing.layout import PackedOperand
from repro_torch.packing.pack import decode_payload_tiles

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KIND_CODES = {"linear": 0, "gated": 1, "residual": 2}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}
# Payload codes of csrc/mpgemm_packed.cu (the same as csrc/pack.cu's).
_PAYLOAD_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3,
                  "fp8e4m3": 4}


def _check_supported(spec: GemmSpec, epilogue: EpilogueSpec, c):
    if spec.grouped or spec.sparse:
        raise NotImplementedError(
            "grouped and tile-sparse GEMMs are not ported yet")
    if spec.trans_a:
        raise NotImplementedError("trans_a is not ported yet")
    if epilogue.beta != 0.0 or c is not None:
        raise NotImplementedError("beta·C accumulation is not ported yet")
    if epilogue.kind not in _KIND_CODES:
        raise NotImplementedError(
            f"epilogue {epilogue.kind!r} is not ported yet")


def _epilogue_plain(epilogue, acc, bias, scale, extras, out_dtype):
    out = apply_epilogue(epilogue, acc,
                         bias=None if bias is None else bias.reshape(1, -1),
                         scale=scale, extras=tuple(extras))
    return out.to(out_dtype)


def mpgemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 extras: Sequence[torch.Tensor] = (),
                 trans_b: bool = False, epilogue: EpilogueSpec = LINEAR,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K1's plain version: the matmul of the (already compute-dtype)
    operands -- f32, or exact for int8 (f64 holds every int8 dot product
    sum of these sizes exactly) -- then :func:`apply_epilogue` in f32, then
    the output cast."""
    wide = torch.float64 if a.dtype == torch.int8 else torch.float32
    bw = b.to(wide)
    acc = (a.to(wide) @ (bw.t() if trans_b else bw)).float()
    return _epilogue_plain(epilogue, acc, bias, scale, extras,
                           out_dtype or a.dtype)


def _check_extras(epilogue, extras):
    n_extra = len(get_epilogue(epilogue.kind).extra_operands)
    if len(extras) != n_extra:
        raise ValueError(f"epilogue {epilogue.kind!r} needs {n_extra} extra "
                         f"operand(s), got {len(extras)}")


def mpgemm(a: torch.Tensor, b, *,
           c: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None,
           scale: Optional[torch.Tensor] = None,
           extras: Sequence[torch.Tensor] = (),
           spec: GemmSpec = GemmSpec(),
           epilogue: EpilogueSpec = LINEAR,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out = tail(alpha · (a @ op(b)) · scale + bias)`` for a (M, K) and b
    (K, N), or (N, K) under ``spec.trans_b``, or a packed operand (K2);
    ``extras`` are the epilogue's (M, N) operands in registry order.
    Output dtype: ``out_dtype``, else ``spec.out_dtype``, else
    ``a.dtype``."""
    if isinstance(b, PackedOperand):
        if spec.trans_b:
            raise ValueError("packed B has its transpose resolved at pack "
                             "time")
        _check_supported(spec, epilogue, c)
        return mpgemm_packed(a, b, bias=bias, scale=scale, extras=extras,
                             epilogue=epilogue,
                             out_dtype=out_dtype or spec.out_dtype)
    if spec.packed:
        raise ValueError("spec.packed needs a PackedOperand b")
    _check_supported(spec, epilogue, c)
    out_dtype = out_dtype or spec.out_dtype or a.dtype
    extras = tuple(extras)
    _check_extras(epilogue, extras)
    if a.device.type == "cpu":
        return mpgemm_plain(a, b, bias=bias, scale=scale, extras=extras,
                            trans_b=spec.trans_b, epilogue=epilogue,
                            out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm: unsupported device {a.device}")
    return _launch(a, b, bias, scale, extras, spec.trans_b, epilogue,
                   out_dtype)


# --- shared argument checks --------------------------------------------------

def _check_a(a, k):
    if a.dim() != 2:
        raise ValueError(f"mpgemm: 2-D A only, got {tuple(a.shape)}")
    if a.shape[1] != k:
        raise ValueError(f"contraction mismatch: A {tuple(a.shape)} against "
                         f"K = {k}")
    if not a.is_contiguous():
        raise ValueError("mpgemm: a must be contiguous")


def _epilogue_args(a, m, n, bias, scale, extras, epilogue, out_dtype):
    """(bias, scale, extra) checked and made kernel-ready."""
    if out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"mpgemm kernel output dtype {out_dtype}")
    if bias is not None:
        if bias.numel() != n or bias.device != a.device:
            raise ValueError(f"mpgemm: bias must hold {n} values on "
                             f"{a.device}")
        bias = bias.reshape(-1).to(torch.float32).contiguous()
    if scale is not None:
        if scale.numel() != 1 or scale.device != a.device:
            raise ValueError(f"mpgemm: scale must be one value on "
                             f"{a.device}")
        scale = scale.reshape(1).to(torch.float32).contiguous()
    extra = None
    if extras:
        (extra,) = extras
        if (tuple(extra.shape) != (m, n) or extra.dtype != out_dtype
                or extra.device != a.device or not extra.is_contiguous()):
            raise ValueError(
                f"mpgemm: the {epilogue.kind} operand must be a contiguous "
                f"({m}, {n}) {out_dtype} tensor on {a.device}, got "
                f"{tuple(extra.shape)} {extra.dtype} on {extra.device}")
    return bias, scale, extra


def _ptr(t):
    return t.data_ptr() if t is not None else None


# --- K1 launch ---------------------------------------------------------------

def _launch(a, b, bias, scale, extras, trans_b, epilogue, out_dtype):
    if b.dim() != 2:
        raise ValueError(f"mpgemm: 2-D operands only, got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"mpgemm kernel takes bf16, f32 or int8 operands of one dtype, "
            f"got {a.dtype} x {b.dtype}")
    n, k = (b.shape if trans_b else b.shape[::-1])
    _check_a(a, k)
    if b.device != a.device:
        raise ValueError(f"mpgemm: b on {b.device}, a on {a.device}")
    if not b.is_contiguous():
        raise ValueError("mpgemm: b must be contiguous")
    m = a.shape[0]
    bias, scale, extra = _epilogue_args(a, m, n, bias, scale, extras,
                                        epilogue, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    rc = lib.mpgemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), _ptr(bias), _ptr(extra),
        _ptr(scale), m, n, k, _DTYPE_CODES[a.dtype], _OUT_CODES[out_dtype],
        int(trans_b), _KIND_CODES[epilogue.kind],
        _ACT_CODES[epilogue.activation], float(epilogue.alpha),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mpgemm kernel launch failed: CUDA error {rc} "
                           f"({lib.mpgemm_error_string(rc).decode()})")
    mpgemm.launches += 1
    return out


mpgemm.launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("mpgemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mpgemm_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  ctypes.c_float, p]
    lib.mpgemm_launch.restype = i
    lib.mpgemm_error_string.argtypes = [i]
    lib.mpgemm_error_string.restype = ctypes.c_char_p
    return lib


# --- K2: packed B ------------------------------------------------------------

def _check_packed_pair(a: torch.Tensor, b: PackedOperand):
    """The (A dtype, payload) pairs K2 and its plain version take."""
    layout = b.layout
    if layout.g != 1:
        raise NotImplementedError("grouped packed operands (MoE) are not "
                                  "ported yet")
    codec = layout.codec
    if a.dtype == torch.int8:
        if codec is None or not codec.integer:
            raise NotImplementedError(
                f"int8 A against a {layout.dtype} payload (takes int8 or "
                "int4)")
    elif a.dtype in (torch.float32, torch.bfloat16):
        if codec is None and b.payload.dtype != a.dtype:
            raise NotImplementedError(
                f"{a.dtype} A against a {layout.dtype} float payload (cast "
                "the payload with PackedOperand.astype first)")
    else:
        raise NotImplementedError(f"packed GEMM A dtype {a.dtype}")


def mpgemm_packed_plain(a: torch.Tensor, b: PackedOperand, *,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        extras: Sequence[torch.Tensor] = (),
                        epilogue: EpilogueSpec = LINEAR,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """K2's plain version, with the reference kernel's per-tile numerics.

    Float A: each codec tile is decoded, scaled in f32 and rounded to A's
    dtype (the reference's ``bf.astype(a.dtype)``), then one f32 matmul.
    Int8 A: one exact partial per K tile (f64 holds it exactly), then
    ``acc += float(partial) · tile_scale`` over the tiles in K order.
    """
    _check_packed_pair(a, b)
    layout = b.layout
    m = a.shape[0]
    tiles = decode_payload_tiles(b.payload, layout)     # (nkb, nnb, bk, bn)
    kp, np_ = layout.nkb * layout.bk, layout.nnb * layout.bn
    ap = torch.nn.functional.pad(a, (0, kp - layout.k))
    if a.dtype == torch.int8:
        a_t = ap.to(torch.float64).reshape(m, layout.nkb, layout.bk)
        w_t = tiles.to(torch.float64).permute(0, 2, 1, 3).reshape(
            layout.nkb, layout.bk, np_)
        parts = torch.einsum("mkb,kbn->kmn", a_t, w_t).float()
        ts = b.scales.float().repeat_interleave(layout.bn, dim=1)  # (nkb, Np)
        acc = torch.zeros(m, np_, dtype=torch.float32, device=a.device)
        for kk in range(layout.nkb):
            acc = acc + parts[kk] * ts[kk]
    else:
        if b.scales is not None:
            tiles = (tiles.float() * b.scales[..., None, None]).to(a.dtype)
        w = tiles.permute(0, 2, 1, 3).reshape(kp, np_)
        acc = ap.float() @ w.float()
    acc = acc[:, :layout.n]
    return _epilogue_plain(epilogue, acc, bias, scale, extras,
                           out_dtype or a.dtype)


def mpgemm_packed(a: torch.Tensor, b: PackedOperand, *,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  extras: Sequence[torch.Tensor] = (),
                  epilogue: EpilogueSpec = LINEAR,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2: ``out = tail(alpha · (a @ dequant(b)) · scale + bias)`` for a
    (M, K) and a packed (K, N) operand.  A bf16/f32 ``a`` takes an int8,
    int4 or fp8e4m3 payload or a float payload of its own dtype; an int8
    ``a`` takes an int8 or int4 payload."""
    out_dtype = out_dtype or a.dtype
    extras = tuple(extras)
    _check_extras(epilogue, extras)
    _check_packed_pair(a, b)
    if a.device.type == "cpu":
        return mpgemm_packed_plain(a, b, bias=bias, scale=scale,
                                   extras=extras, epilogue=epilogue,
                                   out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm_packed: unsupported device {a.device}")
    return _launch_packed(a, b, bias, scale, extras, epilogue, out_dtype)


def _launch_packed(a, b, bias, scale, extras, epilogue, out_dtype):
    layout = b.layout
    if layout.dtype not in _PAYLOAD_CODES:
        raise NotImplementedError(f"packed payload {layout.dtype!r}")
    _check_a(a, layout.k)
    payload, tile_scales = b.payload, b.scales
    if tuple(payload.shape) != layout.payload_shape or \
            payload.device != a.device or not payload.is_contiguous():
        raise ValueError(
            f"mpgemm_packed: payload must be a contiguous "
            f"{layout.payload_shape} tensor on {a.device}, got "
            f"{tuple(payload.shape)} on {payload.device}")
    if layout.per_tile_scales and (
            tile_scales is None or tile_scales.dtype != torch.float32
            or tuple(tile_scales.shape) != layout.scales_shape
            or tile_scales.device != a.device
            or not tile_scales.is_contiguous()):
        raise ValueError(f"mpgemm_packed: scales must be a contiguous f32 "
                         f"{layout.scales_shape} tensor on {a.device}")
    m, n = a.shape[0], layout.n
    bias, scale, extra = _epilogue_args(a, m, n, bias, scale, extras,
                                        epilogue, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0:
        return out
    lib = _packed_lib()
    rc = lib.mpgemm_packed_launch(
        a.data_ptr(), payload.data_ptr(),
        _ptr(tile_scales) if layout.per_tile_scales else None,
        out.data_ptr(), _ptr(bias), _ptr(extra), _ptr(scale),
        m, n, layout.k, layout.bk, layout.bn, _DTYPE_CODES[a.dtype],
        _PAYLOAD_CODES[layout.dtype], _OUT_CODES[out_dtype],
        _KIND_CODES[epilogue.kind], _ACT_CODES[epilogue.activation],
        float(epilogue.alpha),
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"mpgemm_packed kernel launch failed: CUDA error {rc} "
            f"({lib.mpgemm_packed_error_string(rc).decode()})")
    mpgemm_packed.launches += 1
    return out


mpgemm_packed.launches = 0


@functools.lru_cache(maxsize=None)
def _packed_lib() -> ctypes.CDLL:
    lib = _build.load("mpgemm_packed")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mpgemm_packed_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                         i, i, i, i, i, ctypes.c_float, p]
    lib.mpgemm_packed_launch.restype = i
    lib.mpgemm_packed_error_string.argtypes = [i]
    lib.mpgemm_packed_error_string.restype = ctypes.c_char_p
    return lib
