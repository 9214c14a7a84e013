"""K1, K2 and K3 wrappers: the MPGEMM with a fused epilogue (port of
``repro.kernels.mpgemm.mpgemm_pallas_spec`` and ``mpgemm_grouped_pallas``),
2-D or grouped, with dense B (K1), pre-packed B (K2) or tile-sparse B (K3).

:func:`mpgemm` runs one GEMM, :func:`mpgemm_grouped` G of them in one
launch (the MoE expert GEMMs: A (G, M, K) against B (G, K, N)).  Both are
polymorphic in ``b``, as the reference is: a dense tensor goes to K1, a
:class:`~repro_torch.packing.layout.PackedOperand` to K2
(:func:`mpgemm_packed`, :func:`mpgemm_packed_grouped`), a
:class:`~repro_torch.sparse.layout.TileSparseOperand` to K3
(:func:`mpgemm_sparse`, :func:`mpgemm_sparse_grouped`).  Each dispatches
by the device of its operands: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/mpgemm.cu``,
``csrc/mpgemm_packed.cu``, ``csrc/mpgemm_sparse.cu``, built on first use
by ``_build.py``).  K1 takes ``spec.trans_a`` (A read as (K, M), or
(G, K, M) grouped: the backward's dW = Aᵀ·B) and ``spec.trans_b``, alone
or together, for every operand dtype.  K2 and K3 take ``trans_a`` too:
their wrappers hand the kernel the contiguous Aᵀ (one copy of M·K
elements, no arithmetic), and their plain versions read A transposed.

K1 has four designs on the card, and :func:`k1_design` picks one by a
rule (never by trying): bf16 or int8 operands whose row strides and base
pointers are multiples of 16 bytes (TMA's rule) run the ``wgmma`` design
(``csrc/mpgemm_wgmma.cuh``: TMA, ``wgmma``, split-K when the output has
fewer tiles than the card has SMs; built as
``csrc/mpgemm_wgmma.cu`` for bf16 and ``csrc/mpgemm_wgmma_int8.cu`` for
int8, whose MN-major operands are transposed in shared memory); f32
operands under the same rule run ``tf32x3``, the same template built as
``csrc/mpgemm_wgmma_f32.cu``, each value split into tf32 hi and lo terms
and three products summed on the tensor cores, unless the caller keeps
f32 FMA arithmetic (``f32_fma``: the fp32 policy's products), when they
run ``fma`` (``csrc/mpgemm_fma.cu``: f32 FMA on the CUDA cores, register
tiles from a ring of ``cp.async`` stages; the same bits as the scalar
loop); everything else
-- odd shapes such as rows of 101 values, views off a 16-byte boundary --
runs ``csrc/mpgemm.cu``'s scalar loops.  An int8 product sums exactly in
int32 while K <= :data:`INT8_MAX_K`; the card path refuses a deeper one.

K1 takes bf16 or f32 operands summed in f32, or int8 operands summed
exactly in int32 (the int8 policy, and the paper's INT8 -> INT32 GEMM,
whose default output is int32).  An int8 product with no ``scale`` keeps
the reference's integer epilogue (``apply_epilogue``): alpha, the bias and
beta truncated to int32, only relu.  ``scale`` is a one-element f32 tensor
on the operands' device (the int8 policy's ``sx · sw``); the kernels read
it in their epilogue, so no GEMM waits on the host.  ``c`` (the output's
shape, f32, bf16 or int32) is added times ``epilogue.beta``.  A grouped
call takes a bias of shape (G, N), or one (N,) bias shared by every group,
and gate / residual / C operands of the output's shape (G, M, N).  The
``quant_in`` kinds' row scale is an (M, 1) -- grouped (G, M, 1) -- f32
operand, the first of their extras.

K2 has two designs too, picked by :func:`k2_design`: bf16 A against a
bf16, int8, int4 or fp8e4m3 payload and int8 A against an int8 or int4
one, in 128 x 128 tiles with 16-byte aligned operands, run K1's template
with a B stage that decodes the payload in shared memory
(``csrc/mpgemm_packed_wgmma.cu``, ``_int8.cu``; split over the payload's
K tiles); the rest -- f32 A, int8 A against
fp8, other tile shapes -- runs ``csrc/mpgemm_packed.cu``.

K3 has two designs, picked by :func:`k3_design`: bf16 A against bf16 or
int8 tiles and int8 A against int8 tiles, 128 x 128 tiles, 16-byte aligned
operands, run K2's template walking each column's stored tiles
(``csrc/mpgemm_sparse_wgmma.cu``, ``_int8.cu``; split over a column's
stored tiles); the rest -- f32 A, other tiles, misaligned views -- runs
``csrc/mpgemm_sparse.cu``.

**Plans.**  The design rules above pick the kernel from the operands; a
:class:`~repro_torch.core.blocking.GemmPlan` decides how it runs: the tile
rows BM, the split over K ``(splits, per)`` and the ``fma`` tile.  A launch
takes ``plan=`` when its caller gives one, else a tuned plan from the plan
cache (``tuning/plan_cache.py``, ``REPRO_TORCH_PLAN_CACHE``), else the
analytic plan (``core/blocking.py::plan_gemm``), which equals the rules
:func:`k1_wgmma_bm`, :func:`k1_split`, :func:`k2_split`, :func:`k3_split`
and :func:`k1_fma_tile` (they live in ``core/blocking.py`` and are
re-exported here) at every shape.  A packed or sparse B pins the plan's
(bk, bn) to its payload tile (``_layout_plan``); a tuned plan for another
tiling or another design is passed over.  A given or tuned plan outside
the kernel's limits (``core/blocking.py::plan_limits``) raises: nothing
clamps it.  Each launch's plan is resolved once and memoised by what
decides it, until the plan cache changes; a CUDA graph keeps the plans it
was captured with.  The simt kernels and the plain versions take no plan.

``mpgemm.launches``, ``mpgemm_grouped.launches``,
``mpgemm_packed.launches``, ``mpgemm_packed_grouped.launches``,
``mpgemm_sparse.launches`` and ``mpgemm_sparse_grouped.launches`` count
kernel launches (never plain-version calls); ``mpgemm.trans_a_launches``,
``mpgemm.trans_b_launches`` and their ``mpgemm_grouped`` twins count the
K1 launches of each transposed variant among them (a launch with both
counts in both), and ``mpgemm.wgmma_launches`` / ``mpgemm_grouped.
wgmma_launches`` those that ran the wgmma design (bf16 or int8), as
``mpgemm_packed.wgmma_launches`` and ``mpgemm_packed_grouped.
wgmma_launches`` do for K2 and ``mpgemm_sparse(_grouped).wgmma_launches``
for K3; ``mpgemm(_grouped).tf32x3_launches`` count K1's f32 launches on
the tensor cores and ``mpgemm(_grouped).fma_launches`` those on the f32
FMA design; the K2 and K3 wrappers' ``trans_a_launches`` count their
``trans_a`` launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.blocking import (  # noqa: F401 (re-exported rules)
    FMA_TILES, GemmPlan, check_plan, k1_fma_tile, k1_split, k1_wgmma_bk,
    k1_wgmma_bm, k2_split, k3_split, plan_gemm,
)
from repro_torch.core.constants import (  # noqa: F401 (re-exported)
    DEFAULT_HW, H100_SMS, WGMMA_BK, WGMMA_BK_F32, WGMMA_BK_INT8, WGMMA_BN,
    WGMMA_PAYLOAD_TILE, device_spec,
)
from repro_torch.core.gemm_spec import (
    INT_ACTIVATIONS, LINEAR, EpilogueSpec, GemmSpec, apply_epilogue,
    get_epilogue,
)
from repro_torch.kernels import _build
from repro_torch.tuning import plan_cache as _plan_cache
from repro_torch.packing.layout import PackedOperand
from repro_torch.packing.pack import decode_payload_tiles
from repro_torch.sparse.layout import TileSparseOperand

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# Output and C dtypes of csrc/gemm_epilogue.cuh.
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 3}
_KIND_CODES = {"linear": 0, "gated": 1, "residual": 2, "quant_in": 3,
               "quant_in_residual": 4}
_ACT_CODES = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}
# Payload codes of csrc/mpgemm_packed.cu (the same as csrc/pack.cu's).
_PAYLOAD_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3,
                  "fp8e4m3": 4}


def _check_c(epilogue: EpilogueSpec, c):
    if epilogue.beta != 0.0 and c is None:
        raise ValueError("beta != 0 requires c")


def _default_out_dtype(a_dtype: torch.dtype) -> torch.dtype:
    """The reference's default output: int32 for int8 operands, else the
    operands' dtype (``core/blocking.py::_resolve_dtypes``)."""
    return torch.int32 if a_dtype == torch.int8 else a_dtype


def _int_epilogue(a, scale) -> bool:
    """Does K1's epilogue run on an int32 accumulator?  An int8 product
    with no scale (a packed or sparse int8 payload's tile scales make K2's
    and K3's sums f32)."""
    return a.dtype == torch.int8 and scale is None


def _epilogue_plain(epilogue, acc, bias, scale, c, extras, out_dtype):
    out = apply_epilogue(epilogue, acc, bias=bias, scale=scale,
                         c=c if epilogue.beta != 0.0 else None,
                         extras=tuple(extras))
    return out.to(out_dtype)


def mpgemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                 c: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 extras: Sequence[torch.Tensor] = (),
                 trans_a: bool = False, trans_b: bool = False,
                 epilogue: EpilogueSpec = LINEAR,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K1's plain version, 2-D or grouped (a leading G axis on ``a``,
    ``b`` and the extras): the matmul of the (already compute-dtype)
    operands -- f32, or an exact int32 sum for int8 (computed in f64, which
    holds every int8 dot product sum of these sizes exactly) -- then
    :func:`apply_epilogue` (in f32, or in int32 for an int8 product with no
    scale), then the output cast.  ``trans_a`` reads ``a`` as (K, M)."""
    wide = torch.float64 if a.dtype == torch.int8 else torch.float32
    aw, bw = a.to(wide), b.to(wide)
    acc = ((aw.transpose(-1, -2) if trans_a else aw)
           @ (bw.transpose(-1, -2) if trans_b else bw))
    acc = acc.to(torch.int32 if a.dtype == torch.int8 else torch.float32)
    return _epilogue_plain(epilogue, acc, bias, scale, c, extras,
                           out_dtype or _default_out_dtype(a.dtype))


# The plain version is rank-generic: the grouped one is the same function.
mpgemm_grouped_plain = mpgemm_plain


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
           out_dtype: Optional[torch.dtype] = None,
           f32_fma: bool = False,
           plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """``out = tail(alpha · (op(a) @ op(b)) · scale + bias) + beta · c`` for
    a (M, K), or (K, M) under ``spec.trans_a``, and b (K, N), or (N, K)
    under ``spec.trans_b``, or a packed operand (K2), or a tile-sparse one
    (K3); ``extras`` are the epilogue's operands in registry order.  Output
    dtype: ``out_dtype``, else ``spec.out_dtype``, else int32 for int8
    operands and ``a.dtype`` otherwise.  ``f32_fma``: f32 operands keep
    f32 FMA arithmetic (K1's ``fma`` design, the scalar loop's bits: the
    fp32 policy's contract) rather than 3xTF32 (:func:`k1_design`).
    ``plan``: the launch's :class:`GemmPlan` (default: tuned, else
    analytic; the module docstring's **Plans**); it must suit the kernel
    the operands select, or the launch raises."""
    if spec.grouped:
        raise ValueError("a grouped GemmSpec goes to mpgemm_grouped")
    return _mpgemm(a, b, c, bias, scale, extras, spec, epilogue, out_dtype,
                   f32_fma, plan, grouped=False)


def mpgemm_grouped(a: torch.Tensor, b, *,
                   c: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[torch.Tensor] = None,
                   extras: Sequence[torch.Tensor] = (),
                   spec: GemmSpec = GemmSpec(grouped=True),
                   epilogue: EpilogueSpec = LINEAR,
                   out_dtype: Optional[torch.dtype] = None,
                   f32_fma: bool = False,
                   plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """G GEMMs in one launch: ``out[g] = tail(alpha · (op(a[g]) @
    op(b[g])) · scale + bias[g]) + beta · c[g]`` for a (G, M, K) and b
    (G, K, N) (transposes as in :func:`mpgemm`), or a grouped packed (K2)
    or tile-sparse (K3) operand.  ``bias`` is (G, N) or a shared (N,);
    ``c`` and the extras are (G, M, N) (a row scale (G, M, 1)); ``scale``
    is one value for every group; ``f32_fma`` and ``plan`` (for all G
    groups) as :func:`mpgemm`'s."""
    return _mpgemm(a, b, c, bias, scale, extras, spec, epilogue, out_dtype,
                   f32_fma, plan, grouped=True)


def _mpgemm(a, b, c, bias, scale, extras, spec, epilogue, out_dtype,
            f32_fma, plan, *, grouped):
    out_dtype = out_dtype or spec.out_dtype
    if isinstance(b, TileSparseOperand):
        if spec.trans_b or spec.packed:
            raise ValueError("a TileSparseOperand b takes no trans_b or "
                             "packed spec (its transpose is resolved at "
                             "sparsify time)")
        sparse = mpgemm_sparse_grouped if grouped else mpgemm_sparse
        return sparse(a, b, c=c, bias=bias, scale=scale, extras=extras,
                      epilogue=epilogue, out_dtype=out_dtype,
                      trans_a=spec.trans_a, plan=plan)
    if spec.sparse:
        raise ValueError("spec.sparse needs a TileSparseOperand b")
    if isinstance(b, PackedOperand):
        if spec.trans_b:
            raise ValueError("packed B has its transpose resolved at pack "
                             "time")
        packed = mpgemm_packed_grouped if grouped else mpgemm_packed
        return packed(a, b, c=c, bias=bias, scale=scale, extras=extras,
                      epilogue=epilogue, out_dtype=out_dtype,
                      trans_a=spec.trans_a, plan=plan)
    if spec.packed:
        raise ValueError("spec.packed needs a PackedOperand b")
    _check_c(epilogue, c)
    out_dtype = out_dtype or _default_out_dtype(a.dtype)
    extras = tuple(extras)
    _check_extras(epilogue, extras)
    if a.device.type == "cpu":
        return mpgemm_plain(a, b, c=c, bias=bias, scale=scale, extras=extras,
                            trans_a=spec.trans_a, trans_b=spec.trans_b,
                            epilogue=epilogue, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm: unsupported device {a.device}")
    return _launch(a, b, c, bias, scale, extras, spec.trans_a, spec.trans_b,
                   epilogue, out_dtype, grouped, f32_fma, plan)


# --- shared argument checks --------------------------------------------------

def _check_a(a, k, grouped, trans_a=False):
    rank = 3 if grouped else 2
    if a.dim() != rank:
        raise ValueError(f"{'grouped' if grouped else '2-D'} mpgemm: A must "
                         f"have rank {rank}, got {tuple(a.shape)}")
    if a.shape[-2 if trans_a else -1] != k:
        raise ValueError(f"contraction mismatch: A {tuple(a.shape)} against "
                         f"K = {k}")
    if not a.is_contiguous():
        raise ValueError("mpgemm: a must be contiguous")


def _epilogue_args(a, out, c, bias, scale, extras, epilogue, int_acc):
    """The epilogue's arguments of every launch (csrc/gemm_epilogue.cuh),
    checked and made kernel-ready: the tensors to keep alive, then (bias,
    extra, c, row_scale, scale) pointers, (out, C) dtype codes, the bias
    stride (N values shared by every group: 0; (G, N): N), the kind and
    activation codes, alpha and beta.  ``int_acc``: the epilogue runs on
    an int32 accumulator."""
    out_shape, out_dtype = tuple(out.shape), out.dtype
    if out_dtype not in _OUT_CODES:
        raise NotImplementedError(f"mpgemm kernel output dtype {out_dtype}")
    ed = get_epilogue(epilogue.kind)
    if (int_acc and ed.pre is None
            and epilogue.activation not in INT_ACTIVATIONS):
        raise TypeError(f"activation {epilogue.activation!r} does not take "
                        "an integer accumulator; pass a scale to dequantize "
                        "first")
    g, n = (out_shape[0] if len(out_shape) == 3 else 1), out_shape[-1]
    bias_stride = 0
    if bias is not None:
        if bias.device != a.device or bias.numel() not in (n, g * n) or (
                bias.numel() != n and tuple(bias.shape) != (g, n)):
            raise ValueError(f"mpgemm: bias must hold {n} values, or be "
                             f"({g}, {n}), on {a.device}; got "
                             f"{tuple(bias.shape)} on {bias.device}")
        bias_stride = 0 if bias.numel() == n else n
        bias = bias.to(torch.float32).contiguous()
    if scale is not None:
        if scale.numel() != 1 or scale.device != a.device:
            raise ValueError(f"mpgemm: scale must be one value on "
                             f"{a.device}")
        scale = scale.reshape(1).to(torch.float32).contiguous()
    extra = row_scale = None
    for name, t in zip(ed.extra_operands, extras):
        if name in ed.row_operands:
            shape = out_shape[:-1] + (1,)
            if tuple(t.shape) != shape or t.device != a.device:
                raise ValueError(f"mpgemm: the {name} operand must be "
                                 f"{shape} on {a.device}, got "
                                 f"{tuple(t.shape)} on {t.device}")
            row_scale = t.to(torch.float32).contiguous()
        else:
            if (tuple(t.shape) != out_shape or t.dtype != out_dtype
                    or t.device != a.device or not t.is_contiguous()):
                raise ValueError(
                    f"mpgemm: the {name} operand must be a contiguous "
                    f"{out_shape} {out_dtype} tensor on {a.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
            extra = t
    if epilogue.beta == 0.0:
        c = None
    elif tuple(c.shape) != out_shape or c.device != a.device:
        raise ValueError(f"mpgemm: c must be {out_shape} on {a.device}, got "
                         f"{tuple(c.shape)} on {c.device}")
    elif c.dtype not in _OUT_CODES or not c.is_contiguous():
        c = c.to(torch.int32 if int_acc else torch.float32).contiguous()
    kept = (bias, extra, c, row_scale, scale)
    return kept, (_ptr(bias), _ptr(extra), _ptr(c), _ptr(row_scale),
                  _ptr(scale), _OUT_CODES[out_dtype],
                  _OUT_CODES[c.dtype] if c is not None else 0, bias_stride,
                  _KIND_CODES[epilogue.kind],
                  _ACT_CODES[epilogue.activation], float(epilogue.alpha),
                  float(epilogue.beta))


def _ptr(t):
    return t.data_ptr() if t is not None else None


# --- K1's two designs --------------------------------------------------------

# The deepest int8 product whose int32 sum is exact for every int8 input:
# 128 * 128 * K < 2 ** 31.
INT8_MAX_K = 2 ** 31 // (128 * 128) - 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k1_design(a: torch.Tensor, b: torch.Tensor,
              f32_fma: bool = False) -> str:
    """The K1 kernel that runs ``a`` against dense ``b`` on the card, when
    neither is empty and each operand's base pointer and row stride (its
    stored rows, whichever way it is read; the operands are contiguous)
    are multiples of 16 bytes, as TMA needs: ``"wgmma"``
    (``csrc/mpgemm_wgmma.cuh``) when both are bf16 (rows of a multiple of
    8 values) or both int8 (16 values); ``"tf32x3"`` (the same template,
    ``csrc/mpgemm_wgmma_f32.cu``) when both are f32 (4 values), unless the
    caller keeps f32 FMA arithmetic (``f32_fma``), then ``"fma"``
    (``csrc/mpgemm_fma.cu``, the same bits as the scalar loop, which it
    replaces for those operands); else ``"simt"`` (``csrc/mpgemm.cu``).

    The f32 choice is one of precision, not of size: 3xTF32 misses an f32
    product by about 2^-21 of it (``tests/test_torch_k1_design.py``),
    eight times f32's own rounding and far inside the 1e-4 gate of an f32
    output -- the op-level API's f32 GEMM (``ops.mpgemm``, Table III) and
    direct calls run it.  ``mp_dot`` under the fp32 policy passes
    ``f32_fma``: that policy's products (granite's routers, its backward)
    keep f32 FMA's roundings, because a bf16 rounding downstream turns
    3xTF32's error into whole bf16 ulps -- with the fp32 backward's
    products on tf32x3 (all of them, or only those into f32 outputs), 29
    and 44 of the 245,760 bf16 payload-gradient values of
    ``test_mp_dot_backward_on_the_card_matches_the_cpu[packed_bf16-
    fp32]`` came one ulp off a CPU f32 run, none on the scalar loop (H100
    80GB HBM3).  The scalar loop took 0.038 ms for granite's router at
    decode (2 x 1024 x 32, 0.018 on tf32x3) and 104.3 ms for Table III's
    24 shapes (29.8 on tf32x3), which the ``fma`` design now runs with the
    scalar loop's bits.  A rule on what the operands are and what the
    caller asks, not a fallback: a failed build or launch raises."""
    if a.dtype != b.dtype or a.dtype not in _K1_DESIGNS:
        return "simt"
    row = 16 // a.element_size()
    if (a.shape[-1] % row or b.shape[-1] % row
            or a.data_ptr() % 16 or b.data_ptr() % 16
            or not a.numel() or not b.numel()):
        return "simt"
    if a.dtype == torch.float32 and f32_fma:
        return "fma"
    return _K1_DESIGNS[a.dtype]


# K1's tensor-core designs by operand dtype, and their libraries.
_K1_DESIGNS = {torch.bfloat16: "wgmma", torch.int8: "wgmma",
               torch.float32: "tf32x3"}
_K1_LIBS = {torch.bfloat16: "mpgemm_wgmma", torch.int8: "mpgemm_wgmma_int8",
            torch.float32: "mpgemm_wgmma_f32"}


_split_buffers: dict = {}


def _split_workspace(device: torch.device, stream: int, n_partial: int,
                     n_tiles: int) -> tuple:
    """The split buffers of the wgmma designs on ``stream`` (K1's split
    over K, K4's over the keys): the slices' partial sums (``torch.empty``,
    4-byte values: f32, or int32 for an int8 K1) and one int32 counter an
    output tile (``torch.zeros``; each launch leaves them at zero).  One
    pair a stream, grown as needed and kept: the launches on one stream
    run in order, so each has summed its slices before the next writes.
    An allocation a call cost about as much host time as the launch."""
    partial, counters = _split_buffers.get((device, stream), (None, None))
    if partial is None or partial.numel() < n_partial:
        partial = torch.empty(max(n_partial, 1 << 16), dtype=torch.float32,
                              device=device)
    if counters is None or counters.numel() < n_tiles:
        counters = torch.zeros(max(n_tiles, 1024), dtype=torch.int32,
                               device=device)
    _split_buffers[(device, stream)] = partial, counters
    return partial, counters


def split_workspaces() -> list:
    """Every split buffer now kept, on any stream.  A CUDA graph holds
    the raw pointers of those its launches read, and a later growth
    replaces the kept pair, which would free memory the graph still
    writes: whoever captures a graph holds these as long as the graph."""
    return [t for pair in _split_buffers.values() for t in pair]


# --- plans -------------------------------------------------------------------

# Each launch's plan by what decides it (design, device, shape, dtypes,
# transposes, epilogue, and for a packed or sparse B its tag and its most
# stored tiles a column), so that a repeated launch resolves it with one
# dict lookup.  The keys are values and hold no operand: a fresh copy of a
# layout (``astype``) hits.  Dropped whenever the plan cache changes
# (plan_cache.generation()), and when it reaches _PLANS_MAX shapes.
_plans: dict = {}
_plans_generation = -1
_PLANS_MAX = 1 << 16


def _resolve_plan(plan, design, a, b_dtype, m, n, k, g, trans_a, trans_b,
                  out_dtype, epilogue, layout=None, sparse=False):
    """The plan of one K1 (``layout`` None), K2 or K3 launch: ``plan`` when
    given, else a tuned plan from the plan cache, else the memoised
    analytic plan (for a packed or sparse B with (bn, bk) pinned to the
    payload, the reference's ``_layout_plan``).  A given or tuned plan is
    checked against the kernel's limits for this launch and raises outside
    them; a tuned plan for another design or payload tiling is passed over
    (counted ``dropped``).  The simt design's kernels take no plan: None,
    with no lookup, unless one is given.  Plans are keyed with the card's
    spec (``device_spec``); a CPU tensor, which no kernel takes, with the
    SXM5 default."""
    global _plans_generation
    lay = "" if layout is None else "sparse" if sparse else "packed"
    max_count = layout.max_column_tiles if sparse else None
    if plan is None:
        if design == "simt":
            return None
        if _plan_cache.generation() != _plans_generation:
            _plans.clear()
            _plans_generation = _plan_cache.generation()
        key = (design, a.device.index, m, n, k, g, a.dtype, b_dtype,
               out_dtype, trans_a, trans_b, epilogue.kind,
               epilogue.activation, epilogue.beta != 0.0, lay,
               layout.tag if layout is not None else "", max_count)
        hit = _plans.get(key)
        if hit is not None:
            _plan_cache.count_lookup(hit[1])
            return hit[0]
    hw = device_spec(a.device.index) if a.is_cuda else DEFAULT_HW
    launch = dict(design=design, m=m, n=n, k=k, g=g, a_dtype=a.dtype,
                  b_dtype=b_dtype, trans_a=trans_a, trans_b=trans_b,
                  layout=lay, sms=hw.sms,
                  blocks=None if layout is None else (layout.bk, layout.bn),
                  max_count=max_count)
    if plan is not None:
        return check_plan(plan, **launch)
    key_kw = dict(trans_a=trans_a, trans_b=trans_b, beta=epilogue.beta,
                  hw=hw, g=g, epilogue=epilogue.tag,
                  design="fma" if design == "fma" else "")
    if layout is not None:
        key_kw["sparsity" if sparse else "layout"] = layout.tag
    tuned = _plan_cache.lookup_plan(m, n, k, a.dtype, b_dtype, out_dtype,
                                    **key_kw)
    if tuned is not None and (tuned.design != design or (
            layout is not None
            and (tuned.bn, tuned.bk) != (layout.bn, layout.bk))):
        _plan_cache.count_lookup("dropped")
        tuned = None
    if tuned is not None:
        resolved, result = check_plan(tuned, **launch), "hit_tuned"
    else:
        ed = get_epilogue(epilogue.kind)
        resolved, result = plan_gemm(
            m, n, k, a.dtype, b_dtype, out_dtype,
            "float32" if layout is not None and layout.per_tile_scales
            else None, beta=epilogue.beta, hw=hw, g=g, design=design,
            trans_a=trans_a, trans_b=trans_b, layout=lay,
            blocks=launch["blocks"], max_count=max_count,
            extra_mn_inputs=sum(1 for x in ed.extra_operands
                                if x not in ed.row_operands),
            density=layout.density if sparse else 1.0), "hit_analytic"
        _plan_cache.note_analytic_fallback(_plan_cache.make_key(
            m, n, k, a.dtype, b_dtype, out_dtype, **key_kw))
    if len(_plans) >= _PLANS_MAX:
        _plans.clear()
    _plans[key] = (resolved, result)
    return resolved


# --- K1 launch ---------------------------------------------------------------

def _launch(a, b, c, bias, scale, extras, trans_a, trans_b, epilogue,
            out_dtype, grouped, f32_fma=False, plan=None):
    rank = 3 if grouped else 2
    if b.dim() != rank:
        raise ValueError(f"mpgemm: B must have rank {rank}, got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise NotImplementedError(
            f"mpgemm kernel takes bf16, f32 or int8 operands of one dtype, "
            f"got {a.dtype} x {b.dtype}")
    n, k = (b.shape[-2:] if trans_b else b.shape[-2:][::-1])
    _check_a(a, k, grouped, trans_a)
    g = a.shape[0] if grouped else 1
    if grouped and b.shape[0] != g:
        raise ValueError(f"group mismatch: A has {g}, B {b.shape[0]}")
    if b.device != a.device:
        raise ValueError(f"mpgemm: b on {b.device}, a on {a.device}")
    if not b.is_contiguous():
        raise ValueError("mpgemm: b must be contiguous")
    if a.dtype == torch.int8 and k > INT8_MAX_K:
        raise ValueError(f"mpgemm: an int8 product of depth K = {k} can "
                         f"leave int32; the kernels take K <= {INT8_MAX_K}")
    m = a.shape[-1 if trans_a else -2]
    out = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype,
                      device=a.device)
    kept, (bi, ex, cp, rs, sc, out_dt, c_dt, bias_stride, kind, act, alpha,
           beta) = _epilogue_args(a, out, c, bias, scale, extras, epilogue,
                                  _int_epilogue(a, scale))
    if out.numel() == 0:
        return out
    stream = _build.current_stream(a)
    design = k1_design(a, b, f32_fma)
    plan = _resolve_plan(plan, design, a, b.dtype, m, n, k, g, trans_a,
                         trans_b, out_dtype, epilogue)
    if design == "fma":
        bm, bn = plan.bm, plan.bn
        lib = _fma_lib()
        rc = lib.mpgemm_fma_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc,
            g, m, n, k, bias_stride, out_dt, c_dt, int(trans_a),
            int(trans_b), kind, act, alpha, beta, bm, bn, stream)
        error = lib.mpgemm_fma_error_string
    elif design != "simt":
        # tf32x3: ``per`` counts 32-deep stages, whole 128-deep folds (a
        # tf32x3 block holds an SM, so its analytic split is K2's).
        bm, splits, per = plan.bm, plan.splits, plan.per
        partial = counters = None
        if splits > 1:
            partial, counters = _split_workspace(
                a.device, stream, splits * g * m * n,
                g * _cdiv(m, bm) * _cdiv(n, WGMMA_BN))
        name = _K1_LIBS[a.dtype]
        lib = _wgmma_lib(name)
        rc = getattr(lib, f"{name}_launch")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc,
            _ptr(partial), _ptr(counters), g, m, n, k, bias_stride, out_dt,
            c_dt, int(trans_a), int(trans_b), kind, act, alpha, beta, bm,
            splits, per, stream)
        error = getattr(lib, f"{name}_error_string")
    else:
        lib = _lib()
        rc = lib.mpgemm_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc,
            g, m, n, k, bias_stride, _DTYPE_CODES[a.dtype], out_dt, c_dt,
            int(trans_a), int(trans_b), kind, act, alpha, beta, stream)
        error = lib.mpgemm_error_string
    if rc != 0:
        raise RuntimeError(f"mpgemm kernel launch failed: CUDA error {rc} "
                           f"({error(rc).decode()})")
    fn = mpgemm_grouped if grouped else mpgemm
    fn.launches += 1
    fn.wgmma_launches += int(design == "wgmma")
    fn.tf32x3_launches += int(design == "tf32x3")
    fn.fma_launches += int(design == "fma")
    fn.trans_a_launches += int(trans_a)
    fn.trans_b_launches += int(trans_b)
    return out


for _fn in (mpgemm, mpgemm_grouped):
    _fn.launches = _fn.trans_a_launches = _fn.trans_b_launches = 0
    _fn.wgmma_launches = _fn.tf32x3_launches = _fn.fma_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (once)."""
    lib = _build.load("mpgemm")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpgemm_launch.argtypes = [p] * 8 + [i] * 12 + [f, f, p]
    lib.mpgemm_launch.restype = i
    lib.mpgemm_error_string.argtypes = [i]
    lib.mpgemm_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fma_lib() -> ctypes.CDLL:
    """The ``fma`` design's library with its C signatures declared."""
    lib = _build.load("mpgemm_fma")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpgemm_fma_launch.argtypes = [p] * 8 + [i] * 11 + [f, f, i, i, p]
    lib.mpgemm_fma_launch.restype = i
    lib.mpgemm_fma_error_string.argtypes = [i]
    lib.mpgemm_fma_error_string.restype = ctypes.c_char_p
    return lib


# The pointers and the ints before alpha and beta of each wgmma design's
# launch (then alpha, beta, bm, splits, per_split, the stream), by the
# library's name less its ``_int8`` / ``_f32`` suffix: K1, K2, K3.
_WGMMA_ARGS = {"mpgemm_wgmma": (10, 11), "mpgemm_packed_wgmma": (11, 12),
               "mpgemm_sparse_wgmma": (13, 11)}


@functools.lru_cache(maxsize=None)
def _wgmma_lib(name: str) -> ctypes.CDLL:
    """A wgmma design's library ``name`` (K1: ``mpgemm_wgmma`` for bf16,
    ``_int8``, ``_f32``; K2: ``mpgemm_packed_wgmma``, ``_int8``; K3:
    ``mpgemm_sparse_wgmma``, ``_int8``) with its C signatures declared."""
    lib = _build.load(name)
    n_ptr, n_int = _WGMMA_ARGS[name.removesuffix("_int8").removesuffix(
        "_f32")]
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [p] * n_ptr + [i] * n_int + [f, f] + [i] * 3 + [p]
    launch.restype = i
    error = getattr(lib, f"{name}_error_string")
    error.argtypes = [i]
    error.restype = ctypes.c_char_p
    stages = getattr(lib, f"{name}_stages")
    stages.argtypes = ([i, i, i] if name.startswith("mpgemm_wgmma") else
                       [i, i]) + [ctypes.POINTER(i)]
    stages.restype = i
    return lib


def compiled_wgmma_stages(name: str, bm: int, *, trans_a: bool = False,
                          trans_b: bool = False,
                          payload: Optional[str] = None) -> tuple:
    """(stages, shared-memory bytes) that the built wgmma library ``name``
    reports for the instantiation a launch with ``bm`` runs -- K1's by
    ``trans_a`` and ``trans_b``, K2's and K3's by the ``payload`` dtype:
    its ``Cfg::kStages`` and ``Cfg::kSmemBytes``, which the planner's eq.
    (1) (``core/blocking.py::wgmma_stages``) must equal.  (0, 0) for an
    instantiation the library does not build."""
    lib = _wgmma_lib(name)
    smem = ctypes.c_int(0)
    fn = getattr(lib, f"{name}_stages")
    if name.startswith("mpgemm_wgmma"):
        stages = fn(bm, int(trans_a), int(trans_b), ctypes.byref(smem))
    else:
        stages = fn(bm, _PAYLOAD_CODES[payload], ctypes.byref(smem))
    return stages, smem.value if stages else 0


# --- K2: packed B ------------------------------------------------------------

def _check_packed_pair(a: torch.Tensor, b: PackedOperand, grouped: bool):
    """The (A dtype, payload) pairs K2 and its plain version take, and the
    group count."""
    layout = b.layout
    g = a.shape[0] if grouped and a.dim() == 3 else 1
    if layout.g != g:
        raise ValueError(
            f"group mismatch: A has {g} group(s), the packed operand "
            f"{layout.g}" + ("" if grouped else
                             " (a grouped operand goes to mpgemm_grouped)"))
    codec = layout.codec
    if a.dtype == torch.int8:
        if codec is None:
            raise NotImplementedError(
                f"int8 A against a {layout.dtype} payload (takes int8, int4 "
                "or fp8e4m3; upcast A to the payload's dtype first)")
    elif a.dtype in (torch.float32, torch.bfloat16):
        if codec is None and b.payload.dtype != a.dtype:
            raise NotImplementedError(
                f"{a.dtype} A against a {layout.dtype} float payload (cast "
                "the payload with PackedOperand.astype first)")
    else:
        raise NotImplementedError(f"packed GEMM A dtype {a.dtype}")


def mpgemm_packed_plain(a: torch.Tensor, b: PackedOperand, *,
                        c: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        extras: Sequence[torch.Tensor] = (),
                        epilogue: EpilogueSpec = LINEAR,
                        out_dtype: Optional[torch.dtype] = None,
                        trans_a: bool = False) -> torch.Tensor:
    """K2's plain version, with the reference kernel's per-tile numerics;
    2-D (``a`` (M, K), or (K, M) under ``trans_a``) or grouped (``a`` (G,
    M, K) or (G, K, M) against a payload of G groups).

    Float A: each codec tile is decoded, scaled in f32 and rounded to A's
    dtype (the reference's ``bf.astype(a.dtype)``), then one f32 matmul.
    Int8 A against int8 / int4 tiles: one exact partial per K tile (f64
    holds it exactly), then ``acc += float(partial) · tile_scale`` over the
    tiles in K order.  Int8 A against fp8 tiles (the reference's int x
    float branch): both sides in f32, the tile scale applied to B, one f32
    matmul.
    """
    grouped = a.dim() == 3
    _check_packed_pair(a, b, grouped)
    if trans_a:
        a = a.transpose(-1, -2)
    layout = b.layout
    g, nkb, nnb, bk, bn = layout.g, layout.nkb, layout.nnb, layout.bk, \
        layout.bn
    a3 = a if grouped else a[None]
    m = a3.shape[1]
    payload = b.payload.reshape(g, nkb, nnb, *layout.payload_tile)
    tiles = decode_payload_tiles(payload, layout)     # (g, nkb, nnb, bk, bn)
    scales = None if b.scales is None else b.scales.reshape(g, nkb, nnb)
    kp, np_ = nkb * bk, nnb * bn
    ap = F.pad(a3, (0, kp - layout.k))
    if a.dtype == torch.int8 and layout.codec.integer:
        a_t = ap.to(torch.float64).reshape(g, m, nkb, bk)
        w_t = tiles.to(torch.float64).permute(0, 1, 3, 2, 4).reshape(
            g, nkb, bk, np_)
        parts = torch.einsum("gmkb,gkbn->gkmn", a_t, w_t).float()
        ts = scales.float().repeat_interleave(bn, dim=-1)  # (g, nkb, Np)
        acc = torch.zeros(g, m, np_, dtype=torch.float32, device=a.device)
        for kk in range(nkb):
            acc = acc + parts[:, kk] * ts[:, kk, None, :]
    else:
        if scales is not None:
            tiles = tiles.float() * scales[..., None, None]
            if a.dtype != torch.int8:
                tiles = tiles.to(a.dtype)
        w = tiles.permute(0, 1, 3, 2, 4).reshape(g, kp, np_)
        acc = ap.float() @ w.float()
    acc = acc[..., :layout.n]
    return _epilogue_plain(epilogue, acc if grouped else acc[0], bias, scale,
                           c, extras, out_dtype or _default_out_dtype(a.dtype))


# The plain version is rank-generic: the grouped one is the same function.
mpgemm_packed_grouped_plain = mpgemm_packed_plain


def mpgemm_packed(a: torch.Tensor, b: PackedOperand, *,
                  c: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  extras: Sequence[torch.Tensor] = (),
                  epilogue: EpilogueSpec = LINEAR,
                  out_dtype: Optional[torch.dtype] = None,
                  trans_a: bool = False,
                  plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """K2: ``out = tail(alpha · (op(a) @ dequant(b)) · scale + bias) +
    beta · c`` for a (M, K), or (K, M) under ``trans_a``, and a packed (K,
    N) operand.  A bf16/f32 ``a`` takes an int8, int4 or fp8e4m3 payload or
    a float payload of its own dtype; an int8 ``a`` takes an int8, int4 or
    fp8e4m3 payload.  ``plan`` as :func:`mpgemm`'s: its (bk, bn) must be
    the payload's tile."""
    return _packed(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   trans_a, plan, grouped=False)


def mpgemm_packed_grouped(a: torch.Tensor, b: PackedOperand, *,
                          c: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[torch.Tensor] = None,
                          extras: Sequence[torch.Tensor] = (),
                          epilogue: EpilogueSpec = LINEAR,
                          out_dtype: Optional[torch.dtype] = None,
                          trans_a: bool = False,
                          plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Grouped K2: :func:`mpgemm_packed` for a (G, M, K), or (G, K, M)
    under ``trans_a``, against a packed operand of G groups
    (``layout.g``), in one launch; bias (G, N) or a shared (N,), c and
    extras (G, M, N)."""
    return _packed(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   trans_a, plan, grouped=True)


def _a_for_kernel(a, trans_a):
    """K2's and K3's A: their loops read (M, K) rows, so ``trans_a``
    hands them the contiguous Aᵀ, one copy of M·K elements."""
    return a.transpose(-1, -2).contiguous() if trans_a else a


def _packed(a, b, c, bias, scale, extras, epilogue, out_dtype, trans_a, plan,
            *, grouped):
    out_dtype = out_dtype or _default_out_dtype(a.dtype)
    extras = tuple(extras)
    _check_extras(epilogue, extras)
    _check_c(epilogue, c)
    _check_a(a, b.layout.k, grouped, trans_a)
    _check_packed_pair(a, b, grouped)
    if a.device.type == "cpu":
        return mpgemm_packed_plain(a, b, c=c, bias=bias, scale=scale,
                                   extras=extras, epilogue=epilogue,
                                   out_dtype=out_dtype, trans_a=trans_a)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm_packed: unsupported device {a.device}")
    out = _launch_packed(_a_for_kernel(a, trans_a), b, c, bias, scale, extras,
                         epilogue, out_dtype, grouped, plan)
    (mpgemm_packed_grouped if grouped else mpgemm_packed).trans_a_launches \
        += int(trans_a)
    return out


# (A dtype, payload) pairs of K2's wgmma design, and its payload tile.
_K2_WGMMA_PAIRS = {(torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
                   (torch.bfloat16, "int4"), (torch.bfloat16, "fp8e4m3"),
                   (torch.int8, "int8"), (torch.int8, "int4")}
K2_WGMMA_TILE = WGMMA_PAYLOAD_TILE


def k2_design(a: torch.Tensor, b: PackedOperand) -> str:
    """The K2 kernel that runs ``a`` (the kernel's (M, K) or (G, M, K) A)
    against the packed ``b`` on the card: ``"wgmma"``
    (``csrc/mpgemm_packed_wgmma.cu`` for bf16 A, ``_int8.cu`` for int8 A)
    for bf16 A against a bf16, int8, int4 or fp8e4m3 payload and int8 A
    against an int8 or int4 one, in :data:`K2_WGMMA_TILE` tiles
    (``packing/params.py::default_blocks`` wherever K and N reach 128),
    with A's rows and base and the payload's base on 16 bytes and neither
    empty; else ``"simt"`` (``csrc/mpgemm_packed.cu``): f32 A, int8 A
    against fp8e4m3 (the reference's f32 int x float branch), other tile
    shapes, misaligned operands.  A rule on what the operands are, not a
    fallback: a failed build or launch raises."""
    layout = b.layout
    if ((a.dtype, layout.dtype) not in _K2_WGMMA_PAIRS
            or (layout.bk, layout.bn) != K2_WGMMA_TILE
            or (a.shape[-1] * a.element_size()) % 16
            or a.data_ptr() % 16 or b.payload.data_ptr() % 16
            or not a.numel() or not b.payload.numel()):
        return "simt"
    return "wgmma"


def _launch_packed(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   grouped, plan=None):
    layout = b.layout
    if layout.dtype not in _PAYLOAD_CODES:
        raise NotImplementedError(f"packed payload {layout.dtype!r}")
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
    m, n = a.shape[-2], layout.n
    out = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype,
                      device=a.device)
    kept, (bi, ex, cp, rs, sc, out_dt, c_dt, bias_stride, kind, act, alpha,
           beta) = _epilogue_args(a, out, c, bias, scale, extras, epilogue,
                                  False)
    if out.numel() == 0:
        return out
    stream = _build.current_stream(a)
    ts = _ptr(tile_scales) if layout.per_tile_scales else None
    wgmma = k2_design(a, b) == "wgmma"
    g, k = layout.g, layout.k
    plan = _resolve_plan(plan, "wgmma" if wgmma else "simt", a, layout.dtype,
                         m, n, k, g, False, False, out_dtype, epilogue,
                         layout)
    if wgmma:
        int8 = a.dtype == torch.int8
        bm, splits = plan.bm, plan.splits
        # Slices of whole payload tiles (128 deep), in stages of 128 bytes
        # of K: two a tile for bf16 A.
        per = plan.per * (plan.bk // k1_wgmma_bk(a.dtype))
        partial = counters = None
        if splits > 1:
            partial, counters = _split_workspace(
                a.device, stream, splits * g * m * n,
                g * _cdiv(m, bm) * _cdiv(n, WGMMA_BN))
        name = "mpgemm_packed_wgmma_int8" if int8 else "mpgemm_packed_wgmma"
        lib = _wgmma_lib(name)
        rc = getattr(lib, f"{name}_launch")(
            a.data_ptr(), payload.data_ptr(), ts, out.data_ptr(), bi, ex, cp,
            rs, sc, _ptr(partial), _ptr(counters), g, m, n, k, layout.nkb,
            layout.nnb, bias_stride, _PAYLOAD_CODES[layout.dtype], out_dt,
            c_dt, kind, act, alpha, beta, bm, splits, per, stream)
        error = getattr(lib, f"{name}_error_string")
    else:
        lib = _packed_lib()
        rc = lib.mpgemm_packed_launch(
            a.data_ptr(), payload.data_ptr(), ts, out.data_ptr(), bi, ex, cp,
            rs, sc, layout.g, m, n, layout.k, layout.bk, layout.bn,
            bias_stride, _DTYPE_CODES[a.dtype], _PAYLOAD_CODES[layout.dtype],
            out_dt, c_dt, kind, act, alpha, beta, stream)
        error = lib.mpgemm_packed_error_string
    if rc != 0:
        raise RuntimeError(
            f"mpgemm_packed kernel ({'wgmma' if wgmma else 'simt'}) launch "
            f"failed: CUDA error {rc} ({error(rc).decode()})")
    fn = mpgemm_packed_grouped if grouped else mpgemm_packed
    fn.launches += 1
    fn.wgmma_launches += int(wgmma)
    return out


for _fn in (mpgemm_packed, mpgemm_packed_grouped):
    _fn.launches = _fn.trans_a_launches = _fn.wgmma_launches = 0


@functools.lru_cache(maxsize=None)
def _packed_lib() -> ctypes.CDLL:
    lib = _build.load("mpgemm_packed")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpgemm_packed_launch.argtypes = [p] * 9 + [i] * 13 + [f, f, p]
    lib.mpgemm_packed_launch.restype = i
    lib.mpgemm_packed_error_string.argtypes = [i]
    lib.mpgemm_packed_error_string.restype = ctypes.c_char_p
    return lib


# --- K3: tile-sparse B -------------------------------------------------------

# (A dtype, payload dtype) pairs K3 takes: the payload is read with A's own
# type, or, int8, dequantized by its tile scales against float A.
_SPARSE_PAIRS = {(torch.float32, "float32"), (torch.bfloat16, "bfloat16"),
                 (torch.int8, "int8"), (torch.float32, "int8"),
                 (torch.bfloat16, "int8")}


def _check_sparse_pair(a: torch.Tensor, b: TileSparseOperand, grouped: bool):
    """The group count and the (A dtype, payload) pairs K3 and its plain
    version take."""
    layout = b.layout
    g = a.shape[0] if grouped and a.dim() == 3 else 1
    if layout.g != g:
        raise ValueError(
            f"group mismatch: A has {g} group(s), the sparse operand "
            f"{layout.g}" + ("" if grouped else
                             " (a grouped operand goes to mpgemm_grouped)"))
    if (a.dtype, layout.dtype) not in _SPARSE_PAIRS:
        raise NotImplementedError(
            f"sparse GEMM of {a.dtype} A against a {layout.dtype} payload "
            "(takes f32 x float32, bf16 x bfloat16, and int8 payloads "
            "against int8, bf16 or f32 A)")


def mpgemm_sparse_plain(a: torch.Tensor, b: TileSparseOperand, *,
                        c: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        extras: Sequence[torch.Tensor] = (),
                        epilogue: EpilogueSpec = LINEAR,
                        out_dtype: Optional[torch.dtype] = None,
                        trans_a: bool = False) -> torch.Tensor:
    """K3's plain version, 2-D (``a`` (M, K), or (K, M) under
    ``trans_a``) or grouped (``a`` (G, M, K) or (G, K, M) against an
    operand of G groups), in torch ops: gather the A tile of
    each stored tile's k index, one product per stored tile (f32 for float
    operands, exact in f64 for int8, then scaled by the tile's scale; an
    int8 tile against float A dequantized by its scale and rounded to A's
    dtype first), ``index_add`` of the products into their output columns
    in payload order -- on the CPU that is the reference's visit order --
    and the epilogue.  Empty columns keep a zero sum."""
    _check_sparse_pair(a, b, a.dim() == 3)
    return _sparse_plain(a, b, c, bias, scale, extras, epilogue, out_dtype,
                         trans_a)


def _sparse_plain(a, b, c, bias, scale, extras, epilogue, out_dtype,
                  trans_a=False):
    grouped = a.dim() == 3
    if trans_a:
        a = a.transpose(-1, -2)
    layout = b.layout
    g, nkb, nnb, bk, bn, nnz = (layout.g, layout.nkb, layout.nnb, layout.bk,
                                layout.bn, layout.nnz)
    a3 = a if grouped else a[None]
    m, dev = a3.shape[1], a.device
    a_tiles = F.pad(a3, (0, nkb * bk - layout.k)).reshape(g, m, nkb, bk)
    counts = (b.indptr[1:] - b.indptr[:-1]).long()
    col = torch.repeat_interleave(
        torch.arange(g * nnb, device=dev), counts, output_size=nnz)
    kk = b.indices.long()
    a_t = a_tiles[col // nnb, :, kk, :]                 # (nnz, M, bk)
    w_t = b.payload[:nnz]
    if a.dtype == torch.int8:
        parts = torch.bmm(a_t.double(), w_t.double()).float()
        parts = parts * b.scales[:nnz].reshape(-1, 1, 1)
    else:
        if layout.per_tile_scales:
            w_t = (w_t.float() * b.scales[:nnz].reshape(-1, 1, 1)).to(
                a.dtype)
        parts = torch.bmm(a_t.float(), w_t.float())
    acc = torch.zeros(g * nnb, m, bn, dtype=torch.float32, device=dev)
    acc.index_add_(0, col, parts)
    acc = acc.reshape(g, nnb, m, bn).permute(0, 2, 1, 3).reshape(
        g, m, nnb * bn)[..., :layout.n]
    return _epilogue_plain(epilogue, acc if grouped else acc[0], bias, scale,
                           c, extras, out_dtype or _default_out_dtype(a.dtype))


def mpgemm_sparse(a: torch.Tensor, b: TileSparseOperand, *,
                  c: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  extras: Sequence[torch.Tensor] = (),
                  epilogue: EpilogueSpec = LINEAR,
                  out_dtype: Optional[torch.dtype] = None,
                  trans_a: bool = False,
                  plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """K3: ``out = tail(alpha · (op(a) @ b) · scale + bias) + beta · c``
    for a (M, K), or (K, M) under ``trans_a``, and a tile-sparse (K, N)
    operand, walking only its stored tiles: bf16 ``a`` against a bf16
    payload, f32 against f32, and an int8 payload with per-tile scales
    against int8 ``a`` (``scale`` then carries the int8 policy's sx) or
    against bf16 or f32 ``a``.  ``plan`` as :func:`mpgemm_packed`'s (its
    ``per`` counts a column's stored tiles)."""
    return _sparse(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   trans_a, plan, grouped=False)


def mpgemm_sparse_grouped(a: torch.Tensor, b: TileSparseOperand, *,
                          c: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[torch.Tensor] = None,
                          extras: Sequence[torch.Tensor] = (),
                          epilogue: EpilogueSpec = LINEAR,
                          out_dtype: Optional[torch.dtype] = None,
                          trans_a: bool = False,
                          plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """Grouped K3: :func:`mpgemm_sparse` for a (G, M, K), or (G, K, M)
    under ``trans_a``, against a sparse operand of G groups
    (``layout.g``), in one launch; bias (G, N) or a shared (N,), c and
    extras (G, M, N)."""
    return _sparse(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   trans_a, plan, grouped=True)


def _sparse(a, b, c, bias, scale, extras, epilogue, out_dtype, trans_a, plan,
            *, grouped):
    out_dtype = out_dtype or _default_out_dtype(a.dtype)
    extras = tuple(extras)
    _check_extras(epilogue, extras)
    _check_c(epilogue, c)
    _check_a(a, b.layout.k, grouped, trans_a)
    _check_sparse_pair(a, b, grouped)
    if a.device.type == "cpu":
        return _sparse_plain(a, b, c, bias, scale, extras, epilogue,
                             out_dtype, trans_a)
    if a.device.type != "cuda":
        raise ValueError(f"mpgemm_sparse: unsupported device {a.device}")
    out = _launch_sparse(_a_for_kernel(a, trans_a), b, c, bias, scale, extras,
                         epilogue, out_dtype, grouped, plan)
    (mpgemm_sparse_grouped if grouped else mpgemm_sparse).trans_a_launches \
        += int(trans_a)
    return out


def _check_on(name, t, shape, dtype, device):
    if (t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        got = "None" if t is None else (f"{t.dtype} {tuple(t.shape)} on "
                                        f"{t.device}")
        raise ValueError(f"mpgemm_sparse: {name} must be a contiguous "
                         f"{dtype} {tuple(shape)} tensor on {device}, got "
                         f"{got}")


# (A dtype, payload) pairs of K3's wgmma design, and its tile.
_K3_WGMMA_PAIRS = {(torch.bfloat16, "bfloat16"), (torch.bfloat16, "int8"),
                   (torch.int8, "int8")}
K3_WGMMA_TILE = WGMMA_PAYLOAD_TILE


def k3_design(a: torch.Tensor, b: TileSparseOperand) -> str:
    """The K3 kernel that runs ``a`` (the kernel's (M, K) or (G, M, K) A)
    against the tile-sparse ``b`` on the card: ``"wgmma"``
    (``csrc/mpgemm_sparse_wgmma.cu`` for bf16 A, ``_int8.cu`` for int8 A)
    for bf16 A against bf16 or int8 tiles and int8 A against int8 tiles,
    in :data:`K3_WGMMA_TILE` tiles (``sparse/params.py``'s default), with
    A's rows and base and the payload's base on 16 bytes and neither
    empty; else ``"simt"`` (``csrc/mpgemm_sparse.cu``): f32 A, other tile
    shapes, misaligned operands.  A rule on what the operands are, not a
    fallback: a failed build or launch raises."""
    layout = b.layout
    if ((a.dtype, layout.dtype) not in _K3_WGMMA_PAIRS
            or (layout.bk, layout.bn) != K3_WGMMA_TILE
            or (a.shape[-1] * a.element_size()) % 16
            or a.data_ptr() % 16 or b.payload.data_ptr() % 16
            or not a.numel() or not b.payload.numel()):
        return "simt"
    return "wgmma"


def _launch_sparse(a, b, c, bias, scale, extras, epilogue, out_dtype,
                   grouped, plan=None):
    layout, dev = b.layout, a.device
    p_dtype = torch.int8 if layout.per_tile_scales else a.dtype
    _check_on("payload", b.payload, layout.payload_shape, p_dtype, dev)
    if layout.per_tile_scales:
        _check_on("scales", b.scales, layout.scales_shape, torch.float32,
                  dev)
    _check_on("indptr", b.indptr, (layout.g * layout.nnb + 1,),
              torch.int32, dev)
    _check_on("indices", b.indices, (layout.nnz,), torch.int32, dev)
    m, n = a.shape[-2], layout.n
    out = torch.empty((*a.shape[:-2], m, n), dtype=out_dtype, device=dev)
    kept, (bi, ex, cp, rs, sc, out_dt, c_dt, bias_stride, kind, act, alpha,
           beta) = _epilogue_args(a, out, c, bias, scale, extras, epilogue,
                                  False)
    if out.numel() == 0:
        return out
    stream = _build.current_stream(a)
    ts = _ptr(b.scales) if layout.per_tile_scales else None
    wgmma = k3_design(a, b) == "wgmma"
    g = layout.g
    plan = _resolve_plan(plan, "wgmma" if wgmma else "simt", a, layout.dtype,
                         m, n, layout.k, g, False, False, out_dtype, epilogue,
                         layout, sparse=True)
    if wgmma:
        bm, splits, per = plan.bm, plan.splits, plan.per
        partial = counters = None
        if splits > 1:
            partial, counters = _split_workspace(
                dev, stream, splits * g * m * n,
                g * _cdiv(m, bm) * _cdiv(n, WGMMA_BN))
        name = ("mpgemm_sparse_wgmma_int8" if a.dtype == torch.int8
                else "mpgemm_sparse_wgmma")
        lib = _wgmma_lib(name)
        rc = getattr(lib, f"{name}_launch")(
            a.data_ptr(), b.payload.data_ptr(), ts, b.indptr.data_ptr(),
            b.indices.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc,
            _ptr(partial), _ptr(counters), g, m, n, layout.k, layout.nnz,
            bias_stride, _PAYLOAD_CODES[layout.dtype], out_dt, c_dt, kind,
            act, alpha, beta, bm, splits, per, stream)
        error = getattr(lib, f"{name}_error_string")
    else:
        lib = _sparse_lib()
        rc = lib.mpgemm_sparse_launch(
            a.data_ptr(), b.payload.data_ptr(), ts, b.indptr.data_ptr(),
            b.indices.data_ptr(), out.data_ptr(), bi, ex, cp, rs, sc,
            layout.g, m, n, layout.k, layout.bk, layout.bn, bias_stride,
            _DTYPE_CODES[a.dtype], _DTYPE_CODES[p_dtype], out_dt, c_dt, kind,
            act, alpha, beta, stream)
        error = lib.mpgemm_sparse_error_string
    if rc != 0:
        raise RuntimeError(
            f"mpgemm_sparse kernel ({'wgmma' if wgmma else 'simt'}) launch "
            f"failed: CUDA error {rc} ({error(rc).decode()})")
    fn = mpgemm_sparse_grouped if grouped else mpgemm_sparse
    fn.launches += 1
    fn.wgmma_launches += int(wgmma)
    return out


for _fn in (mpgemm_sparse, mpgemm_sparse_grouped):
    _fn.launches = _fn.trans_a_launches = _fn.wgmma_launches = 0


@functools.lru_cache(maxsize=None)
def _sparse_lib() -> ctypes.CDLL:
    lib = _build.load("mpgemm_sparse")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mpgemm_sparse_launch.argtypes = [p] * 11 + [i] * 13 + [f, f, p]
    lib.mpgemm_sparse_launch.restype = i
    lib.mpgemm_sparse_error_string.argtypes = [i]
    lib.mpgemm_sparse_error_string.restype = ctypes.c_char_p
    return lib
