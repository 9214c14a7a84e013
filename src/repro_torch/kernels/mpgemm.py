"""K1 wrapper: the dense 2-D MPGEMM with a fused epilogue (port of the dense
branch of ``repro.kernels.mpgemm.mpgemm_pallas_spec``).

:func:`mpgemm` dispatches by the device of its operands: a CPU tensor runs
:func:`mpgemm_plain`, a CUDA tensor launches the hand-written kernel in
``csrc/mpgemm.cu`` (built on first use by ``_build.py``).  Variants the
kernel does not take yet -- ``trans_a``, ``beta·C``, a scalar ``scale``,
int8, grouped, packed and sparse B -- raise ``NotImplementedError`` on
every device, so the CPU path never offers what the card cannot run.

``mpgemm.launches`` counts kernel launches (never plain-version calls).
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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KIND_CODES = {"linear": 0, "gated": 1, "residual": 2}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}


def _check_supported(spec: GemmSpec, epilogue: EpilogueSpec, c, scale):
    if spec.grouped or spec.packed or spec.sparse:
        raise NotImplementedError(
            "grouped, packed and tile-sparse GEMMs are not ported yet")
    if spec.trans_a:
        raise NotImplementedError("trans_a is not ported yet")
    if epilogue.beta != 0.0 or c is not None:
        raise NotImplementedError("beta·C accumulation is not ported yet")
    if scale is not None:
        raise NotImplementedError("the scalar dequant scale is not ported "
                                  "yet")
    if epilogue.kind not in _KIND_CODES:
        raise NotImplementedError(
            f"epilogue {epilogue.kind!r} is not ported yet")


def mpgemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 extras: Sequence[torch.Tensor] = (),
                 trans_b: bool = False, epilogue: EpilogueSpec = LINEAR,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K1's plain version: f32 matmul of the (already compute-dtype)
    operands, then :func:`apply_epilogue` in f32, then the output cast."""
    bf = b.float()
    acc = a.float() @ (bf.t() if trans_b else bf)
    out = apply_epilogue(epilogue, acc,
                         bias=None if bias is None else bias.reshape(1, -1),
                         extras=tuple(extras))
    return out.to(out_dtype or a.dtype)


def mpgemm(a: torch.Tensor, b: torch.Tensor, *,
           c: Optional[torch.Tensor] = None,
           bias: Optional[torch.Tensor] = None,
           scale: Optional[torch.Tensor] = None,
           extras: Sequence[torch.Tensor] = (),
           spec: GemmSpec = GemmSpec(),
           epilogue: EpilogueSpec = LINEAR,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out = tail(alpha · a @ op(b) + bias)`` for a (M, K) and b (K, N),
    or (N, K) under ``spec.trans_b``; ``extras`` are the epilogue's (M, N)
    operands in registry order.  Output dtype: ``out_dtype``, else
    ``spec.out_dtype``, else ``a.dtype``."""
    _check_supported(spec, epilogue, c, scale)
    out_dtype = out_dtype or spec.out_dtype or a.dtype
    extras = tuple(extras)
    n_extra = len(get_epilogue(epilogue.kind).extra_operands)
    if len(extras) != n_extra:
        raise ValueError(f"epilogue {epilogue.kind!r} needs {n_extra} extra "
                         f"operand(s), got {len(extras)}")
    if a.device.type == "cpu":
        return mpgemm_plain(a, b, bias=bias, extras=extras,
                            trans_b=spec.trans_b, epilogue=epilogue,
                            out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm: unsupported device {a.device}")
    return _launch(a, b, bias, extras, spec.trans_b, epilogue, out_dtype)


def _launch(a, b, bias, extras, trans_b, epilogue, out_dtype):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mpgemm: 2-D operands only, got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"mpgemm kernel takes bf16 or f32 operands of one dtype, got "
            f"{a.dtype} x {b.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"mpgemm kernel output dtype {out_dtype}")
    m, k = a.shape
    n, kb = (b.shape if trans_b else b.shape[::-1])
    if k != kb:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} x "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    for name, t in (("a", a), ("b", b)):
        if t.device != a.device:
            raise ValueError(f"mpgemm: {name} on {t.device}, a on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"mpgemm: {name} must be contiguous")
    if bias is not None:
        if bias.numel() != n or bias.device != a.device:
            raise ValueError(f"mpgemm: bias must hold {n} values on "
                             f"{a.device}")
        bias = bias.reshape(-1).to(torch.float32).contiguous()
    extra = None
    if extras:
        (extra,) = extras
        if (tuple(extra.shape) != (m, n) or extra.dtype != out_dtype
                or extra.device != a.device or not extra.is_contiguous()):
            raise ValueError(
                f"mpgemm: the {epilogue.kind} operand must be a contiguous "
                f"({m}, {n}) {out_dtype} tensor on {a.device}, got "
                f"{tuple(extra.shape)} {extra.dtype} on {extra.device}")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _lib()
    rc = lib.mpgemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        extra.data_ptr() if extra is not None else None,
        m, n, k, _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype],
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
    lib.mpgemm_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                  ctypes.c_float, p]
    lib.mpgemm_launch.restype = i
    lib.mpgemm_error_string.argtypes = [i]
    lib.mpgemm_error_string.restype = ctypes.c_char_p
    return lib
