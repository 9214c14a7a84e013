"""``mp_dot`` / ``mp_dot_grouped`` — the mixed-precision GEMM ops every
projection and every MoE expert GEMM go through (port of
``repro.core.gemm.mp_dot`` and ``mp_dot_grouped``, with their one
differentiable core).

Each applies a :class:`PrecisionPolicy`, resolves the fusion epilogue from
named operands, and hands one 2-D GEMM (``mp_dot``) or one grouped GEMM of
G independent products (``mp_dot_grouped``, one launch) to the kernel
wrappers, which run the CUDA kernels for CUDA tensors and the plain
versions for CPU tensors:

* dense ``b`` under fp32 / bf16: both operands cast to the compute dtype,
  f32 sum (K1);
* a static int8 ``b`` (``core/quantization.py``'s ``{"q", "scale"}``
  dict): dequantized first, to the compute dtype, or under int8 to f32,
  which then takes the dense int8 path below, as the reference's
  ``_dequant_static`` does (so autograd sees a dense weight);
* dense ``b`` under int8: both operands quantized per tensor, int32 sum,
  ``sx · sw`` in the epilogue's scale slot (K1's int8 variant); a grouped
  call quantizes the whole (G, M, K) activation buffer and the whole
  (G, K, N) expert stack, one scale each, as the reference does;
* packed ``b`` (:class:`~repro_torch.packing.layout.PackedOperand`): the
  payload is read as it is (K2) -- a float payload takes ``x`` in the
  compute dtype, a codec payload under a float policy takes bf16 ``x``,
  an int8/int4 payload under int8 takes per-tensor-quantized ``x`` with
  ``sx`` in the scale slot, and an fp8 payload under int8 takes bf16 ``x``
  (there is no int8 x fp8 product).  A float payload under int8 is
  unpacked (K7) and re-quantized like a dense weight;
* tile-sparse ``b`` (:class:`~repro_torch.sparse.layout.TileSparseOperand`):
  only the stored tiles are read (K3) -- a float payload takes ``x`` in
  the compute dtype (the payload cast to it, a no-op when sparsified under
  the same policy), an int8 payload under int8 takes per-tensor-quantized
  ``x`` with ``sx`` in the scale slot.  A float payload under int8 is
  densified (plain torch ops, zeros at the pruned tiles) and takes the
  dense int8 path (K1), as in the reference.  An int8 payload under a
  float policy takes ``x`` in the compute dtype against the int8 tiles,
  each dequantized by its scale (K3's float x int8 loop);
* ``quant_in=True`` (the ``quant_in`` / ``quant_in_residual`` epilogues):
  ``x`` is quantized per row to int8 before the launch, and its (M, 1)
  row scales ride the epilogue -- a dense weight is quantized per tensor
  (int8 x int8 in K1, its scale in the scalar slot), an int8, int4 or fp8
  payload dots against the int8 ``x`` (K2; fp8 in f32), an int8 sparse
  payload in int32 (K3), and a float payload, packed or sparse, against
  ``x``'s int values upcast to the compute dtype.  Still one launch.

Every call that autograd records goes through one
``torch.autograd.Function`` (:class:`_Gemm`, the port of ``_gemm_core`` /
``_gemm_fwd`` / ``_gemm_bwd``; a call it does not record runs the same
forward without it), whose backward
runs fused-transpose GEMMs through K1: ``dx = dz · op(w)ᵀ`` (``trans_b``
for a (k, n) weight) and ``dW = xᵀ · dz`` (``trans_a``; ``dzᵀ · x`` for a
weight stored (n, k)), in the weight's storage orientation, so no
transposed copy is made.  The backward runs in fp32 under fp32 and in bf16
otherwise (the int8 policy's straight-through estimator), with f32 sums
(the kernel path's numerics).  An epilogue whose rule needs the pre-tail
value recomputes it with one more forward GEMM; alpha is chained; dbias is
the f32 row sum of dz.  A packed weight is unpacked by K7; a float
payload's cotangent is its packed dense gradient (K6 on the card), a
codec payload is frozen (no gradient).  A sparse weight is densified and
its cotangent masked to the stored tiles (``payload_cotangent``).
Under ``quant_in`` the backward is straight-through: the gradients of the
float GEMM, the rounding ignored.

:func:`mp_einsum` routes grouped-matmul einsum specs through
:func:`mp_dot_grouped` and runs any other spec as a plain torch einsum
under the policy's dtypes.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gemm_spec import (
    LINEAR, EpilogueSpec, GemmSpec, epilogue_bwd, epilogue_needs_pre,
    get_epilogue, resolve_epilogue,
)
from repro_torch.core.policy import PrecisionPolicy, get_policy, \
    quantize_per_tensor
from repro_torch.core.quantization import dequantize_tensor, is_quantized
from repro_torch.kernels.mpgemm import mpgemm, mpgemm_grouped
from repro_torch.packing.layout import PackedOperand
from repro_torch.packing.pack import pack_operand, unpack_operand
from repro_torch.sparse.layout import TileSparseOperand
from repro_torch.sparse.sparsify import densify_operand, payload_cotangent


def _build_epilogue(epilogue, activation, gate, residual, epilogue_operands,
                    quant_in=False):
    """The op-level EpilogueSpec and ordered extras (registry-resolved);
    ``quant_in`` selects the activation-quantization family, which is
    explicit only: never with an explicit epilogue or a gate."""
    named = {"gate": gate, "residual": residual}
    if epilogue_operands:
        named.update(epilogue_operands)
    if quant_in:
        if epilogue is not None:
            raise ValueError(
                "pass quant_in=True OR an explicit epilogue spec, not both")
        if gate is not None:
            raise ValueError(
                "quant_in does not compose with the gated epilogue")
        kind = "quant_in_residual" if residual is not None else "quant_in"
        epilogue = EpilogueSpec(kind=kind, activation=activation)
        activation = None
    epilogue, extras = resolve_epilogue(named, epilogue=epilogue,
                                        activation=activation)
    if epilogue.beta != 0.0:
        raise ValueError(
            "beta·C accumulation is a kernel-level epilogue; mp_dot has no C "
            "operand")
    return epilogue, extras


def _apply_gemm(x, w, bias, extras, trans_w: bool, epilogue: EpilogueSpec,
                policy: PrecisionPolicy, out_dtype,
                grouped: bool = False, trans_a: bool = False) -> torch.Tensor:
    """One 2-D or grouped GEMM under a policy -- the dispatch point (the
    reference's ``_apply_gemm`` on its kernel backends).  ``trans_a``
    (a dense float ``w`` only) reads ``x`` as (K, M): the backward's dW."""
    gemm = mpgemm_grouped if grouped else mpgemm
    ed = get_epilogue(epilogue.kind)
    if ed.pre is not None:
        return _apply_quant_in(x, w, bias, extras, trans_w, epilogue, ed,
                               policy, out_dtype, gemm, grouped)
    kw = dict(bias=bias, extras=extras, epilogue=epilogue,
              out_dtype=out_dtype)
    if isinstance(w, TileSparseOperand):
        if not policy.quantized or w.layout.per_tile_scales:
            spec = GemmSpec(grouped=grouped, sparse=True,
                            out_dtype=out_dtype)
            if policy.quantized:
                xq, sx = quantize_per_tensor(x)
                return gemm(xq.contiguous(), w, scale=sx, spec=spec, **kw)
            return gemm(x.to(policy.compute).contiguous(),
                        w.astype(policy.compute), spec=spec, **kw)
        # A float payload under the dynamic-int8 policy: per-tensor weight
        # quantization needs the dense weight (zeros at the pruned tiles).
        w = densify_operand(w)
        trans_w = False
    if isinstance(w, PackedOperand):
        layout = w.layout
        if layout.per_tile_scales or not policy.quantized:
            spec = GemmSpec(grouped=grouped, packed=True,
                            out_dtype=out_dtype)
            if policy.quantized:
                if not layout.codec.integer:
                    return gemm(x.to(torch.bfloat16).contiguous(), w,
                                spec=spec, **kw)
                xq, sx = quantize_per_tensor(x)
                return gemm(xq.contiguous(), w, scale=sx, spec=spec, **kw)
            if not layout.per_tile_scales:
                w = w.astype(policy.compute)   # no-op when packed right
            return gemm(x.to(policy.compute).contiguous(), w, spec=spec,
                        **kw)
        # A float payload under the dynamic-int8 policy: per-tensor weight
        # quantization needs the dense weight back.
        w = unpack_operand(w)
        trans_w = False
    spec = GemmSpec(grouped=grouped, trans_a=trans_a, trans_b=trans_w,
                    out_dtype=out_dtype)
    if policy.quantized:
        xq, sx = quantize_per_tensor(x)
        wq, sw = quantize_per_tensor(w)
        return gemm(xq.contiguous(), wq.contiguous(), scale=sx * sw,
                    spec=spec, **kw)
    # The fp32 policy keeps f32 FMA arithmetic (K1's fma design, not
    # 3xTF32: kernels/mpgemm.py::k1_design).
    return gemm(x.to(policy.compute).contiguous(),
                w.to(policy.compute).contiguous(), spec=spec,
                f32_fma=policy.compute == torch.float32, **kw)


def _apply_quant_in(x, w, bias, extras, trans_w, epilogue, ed, policy,
                    out_dtype, gemm, grouped):
    """The ``quant_in`` forward (the reference's ``pre_quant`` branches):
    the pre-stage quantizes ``x`` per row and its row scales lead the
    extras; then one launch, by weight form."""
    if bias is not None:
        raise ValueError(
            f"epilogue {epilogue.kind!r} does not take a bias (the fused "
            "per-row dequant would rescale it)")
    xq, pre_extras = ed.pre(epilogue, x)
    kw = dict(extras=tuple(pre_extras) + tuple(extras), epilogue=epilogue,
              out_dtype=out_dtype)
    if isinstance(w, (TileSparseOperand, PackedOperand)):
        spec = GemmSpec(grouped=grouped, out_dtype=out_dtype,
                        sparse=isinstance(w, TileSparseOperand),
                        packed=isinstance(w, PackedOperand))
        if w.layout.per_tile_scales:
            # int8 / int4 / fp8 tiles against the int8 rows (K2, K3).
            return gemm(xq.contiguous(), w, spec=spec, **kw)
        # A float payload: the int values upcast to the compute dtype.
        return gemm(xq.to(policy.compute).contiguous(),
                    w.astype(policy.compute), spec=spec, **kw)
    # A dense weight: quantized per tensor, its scale in the scalar slot.
    wq, sw = quantize_per_tensor(w)
    spec = GemmSpec(grouped=grouped, trans_b=trans_w, out_dtype=out_dtype)
    return gemm(xq.contiguous(), wq.contiguous(), scale=sw, spec=spec, **kw)


def _dequant_static(w, policy: PrecisionPolicy):
    """A static int8 ``{"q", "scale"}`` dict as a dense weight: f32 under
    the int8 policy (quantized per call after, as any f32 weight), else the
    compute dtype.  Any other operand is returned as it is."""
    if not is_quantized(w):
        return w
    return dequantize_tensor(
        w, torch.float32 if policy.quantized else policy.compute)


_OPERANDS = ("a dense tensor, a PackedOperand, a TileSparseOperand or a "
             "static int8 {'q', 'scale'} dict")


def _bwd_policy(policy: PrecisionPolicy) -> PrecisionPolicy:
    """The backward's policy: fp32 under fp32, else bf16 (the int8 policy's
    straight-through estimator); the kernels sum in f32 either way (the
    reference's ``_bwd_flavor`` on its kernel backends)."""
    return get_policy("fp32" if policy.name == "fp32" else "bf16")


def _as_operand(w, w_tensor):
    """The operand ``w`` with ``w_tensor`` (the autograd input: the dense
    weight or the payload) in its place."""
    if isinstance(w, PackedOperand):
        return PackedOperand(w_tensor, w.scales, w.layout)
    if isinstance(w, TileSparseOperand):
        return TileSparseOperand(w_tensor, w.scales, w.layout, w.indptr,
                                 w.indices)
    return w_tensor


def _weight_cotangent(w, dw_dense):
    """The cotangent of ``w``'s autograd input from the dense (k, n) /
    (g, k, n) gradient: itself for a dense weight, the packed gradient of a
    float payload (K6 on the card), the gradient masked to the stored
    tiles of a sparse one."""
    if isinstance(w, PackedOperand):
        layout = w.layout
        # dw_dense is in the logical orientation: do not transpose again.
        return pack_operand(dw_dense, (layout.bk, layout.bn), trans_w=False,
                            dtype=layout.dtype).payload
    if isinstance(w, TileSparseOperand):
        return payload_cotangent(dw_dense, w.layout)
    return dw_dense


class _Gemm(torch.autograd.Function):
    """The one differentiable core of ``mp_dot`` and ``mp_dot_grouped``.

    Inputs: ``meta`` = (the operand ``w`` -- a dense tensor, a
    PackedOperand or a TileSparseOperand --, trans_w, epilogue, policy,
    out_dtype, grouped), then the tensors autograd tracks: ``x``, the
    weight tensor (dense ``w`` or the payload), ``bias`` and the extras.
    """

    @staticmethod
    def forward(ctx, meta, x, w_tensor, bias, *extras):
        w, trans_w, epilogue, policy, out_dtype, grouped = meta
        ctx.meta = meta
        ctx.save_for_backward(x, w_tensor, bias, *extras)
        return _apply_gemm(x, _as_operand(w, w_tensor), bias, extras,
                           trans_w, epilogue, policy, out_dtype, grouped)

    @staticmethod
    def backward(ctx, dy):
        w, trans_w, epilogue, policy, _, grouped = ctx.meta
        x, w_tensor, bias, *extras = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[1:3]
        bpol = _bwd_policy(policy)
        w = _as_operand(w, w_tensor)
        frozen = (isinstance(w, (PackedOperand, TileSparseOperand))
                  and w.layout.per_tile_scales)
        if isinstance(w, PackedOperand):
            w_dense, w_trans = unpack_operand(w), False        # K7
        elif isinstance(w, TileSparseOperand):
            w_dense, w_trans = densify_operand(w), False
        else:
            w_dense, w_trans = w, trans_w

        z = None
        if epilogue_needs_pre(epilogue):
            z = _apply_gemm(x, w_dense, bias, (), w_trans,
                            EpilogueSpec(alpha=epilogue.alpha), bpol,
                            torch.float32, grouped)
        dz, dextras = epilogue_bwd(epilogue, z, tuple(extras), dy.float())
        # z = alpha·acc + bias: dacc = alpha·dz, dbias = Σ dz (unscaled).
        # The int8 policy's dequant scale is not chained (STE).
        dzg = dz * epilogue.alpha if epilogue.alpha != 1.0 else dz

        dx = dw = dbias = None
        if need_x:
            # dx = dzg · op(w)ᵀ: a (k, n) weight is read as B^T.
            dx = _apply_gemm(dzg, w_dense, None, (), not w_trans, LINEAR,
                             bpol, x.dtype, grouped)
        if need_w and not frozen:
            # dW in the weight's storage orientation: (k, n) = xᵀ · dzg,
            # (n, k) = dzgᵀ · x.
            a, b = (dzg, x) if w_trans else (x, dzg)
            dw = _weight_cotangent(w, _apply_gemm(
                a, b, None, (), False, LINEAR, bpol, w_dense.dtype, grouped,
                trans_a=True))
        if bias is not None and ctx.needs_input_grad[3]:
            dbias = dz.sum(dim=-2, dtype=torch.float32)
            if grouped and bias.dim() == 1:
                dbias = dbias.sum(0)             # one row shared by groups
            dbias = dbias.to(bias.dtype)
        return (None, dx, dw, dbias, *dextras)


def _gemm(x, w, bias, extras, trans_w, epilogue, policy, out_dtype,
          grouped=False):
    """Run one GEMM through :class:`_Gemm` -- or, when autograd records
    nothing (serving, under inference mode or with no input that requires
    a gradient), its forward alone: the same kernels without
    ``Function.apply``'s host cost on every launch of a host-bound step."""
    w_tensor = w if isinstance(w, torch.Tensor) else w.payload
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_tensor, bias, *extras))):
        return _apply_gemm(x, w, bias, extras, trans_w, epilogue, policy,
                           out_dtype, grouped)
    meta = (w, trans_w, epilogue, policy, out_dtype, grouped)
    return _Gemm.apply(meta, x, w_tensor, bias, *extras)


def mp_dot(
    x: torch.Tensor,
    b,
    bias: Optional[torch.Tensor] = None,
    *,
    policy="bf16",
    trans_w: bool = False,
    out_dtype: Optional[torch.dtype] = None,
    activation: Optional[str] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    epilogue: Optional[EpilogueSpec] = None,
    epilogue_operands: Optional[dict] = None,
    quant_in: bool = False,
) -> torch.Tensor:
    """y[..., n] = tail(x[..., k] @ (b[n, k]ᵀ if trans_w else b[k, n]) + bias).

    ``b`` is a dense tensor, a :class:`PackedOperand` or a
    :class:`TileSparseOperand`, whose ``trans_w`` must match the one it
    was made with (the transpose is resolved at pack / sparsify time), or a
    static int8 ``{"q", "scale"}`` dict (``core/quantization.py``),
    dequantized before the GEMM.
    ``activation`` fuses an activation into the GEMM's store; ``gate``
    fuses ``act(·) · gate`` and ``residual`` fuses ``act(·) + residual``
    (both shaped like the output).  A dense weight already in the compute
    dtype (cast once at load time) is used as it is.

    ``quant_in=True`` quantizes ``x`` per token row to int8 before the
    launch and fuses the per-row dequant (+ ``activation``, + ``residual``)
    into the epilogue: quantize, GEMM and dequant in one launch, with a
    straight-through backward.  It takes no ``bias`` and no ``gate``.
    """
    policy = get_policy(policy)
    b = _dequant_static(b, policy)
    if isinstance(b, (PackedOperand, TileSparseOperand)):
        if b.layout.g != 1:
            raise ValueError(f"grouped {type(b).__name__}: use "
                             "mp_dot_grouped")
        if trans_w != b.layout.trans_w:
            raise ValueError(
                f"trans_w={trans_w} but the operand was made with "
                f"trans_w={b.layout.trans_w} (transposition is resolved "
                "when it is packed or sparsified)")
        n = b.layout.n
    elif isinstance(b, torch.Tensor):
        n = b.shape[0] if trans_w else b.shape[-1]
    else:
        raise TypeError(f"mp_dot: unsupported operand {type(b).__name__}; "
                        f"b is {_OPERANDS}")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if bias is not None:
        bias = bias.reshape(-1)
    epilogue, extras = _build_epilogue(epilogue, activation, gate, residual,
                                       epilogue_operands, quant_in)
    extras = tuple(e.reshape(-1, e.shape[-1]).contiguous() for e in extras)
    out_dtype = out_dtype or policy.out
    y2d = _gemm(x2d, b, bias, extras, trans_w, epilogue, policy, out_dtype)
    return y2d.reshape(*lead, n)


def mp_dot_grouped(
    x: torch.Tensor,
    b,
    bias: Optional[torch.Tensor] = None,
    *,
    policy="bf16",
    trans_w: bool = False,
    group_sizes: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    activation: Optional[str] = None,
    gate: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    epilogue: Optional[EpilogueSpec] = None,
    epilogue_operands: Optional[dict] = None,
    quant_in: bool = False,
) -> torch.Tensor:
    """y[g, m, n] = tail(x[g, m, k] @ (b[g, n, k]ᵀ if trans_w else
    b[g, k, n]) + bias[g, n]): G independent GEMMs in one launch.

    ``b`` is a dense (G, K, N) tensor, a grouped :class:`PackedOperand`
    or :class:`TileSparseOperand` (``layout.g == G``, ``trans_w`` as
    made), or a static int8 ``{"q", "scale"}`` dict of a (G, K, N) stack,
    dequantized before the GEMM.  ``bias`` is (G, N), or one (N,) row that
    every group adds (the reference broadcasts it to (G, N); the kernels
    read it with a group stride of 0).  ``gate`` and ``residual`` are (G,
    M, N).  ``group_sizes`` (G,) marks ragged groups:
    rows ``>= group_sizes[g]`` of each output group are zero.
    ``out_dtype`` overrides the policy's output dtype (MoE keeps the
    expert GEMMs' outputs in f32).  ``quant_in`` is :func:`mp_dot`'s, per
    row of each group.
    """
    if x.dim() != 3:
        raise ValueError(f"mp_dot_grouped expects x of rank 3, got "
                         f"{tuple(x.shape)}")
    g = x.shape[0]
    policy = get_policy(policy)
    b = _dequant_static(b, policy)
    if isinstance(b, (PackedOperand, TileSparseOperand)):
        if b.layout.g != g:
            raise ValueError(f"group mismatch: x has {g}, payload "
                             f"{b.layout.g}")
        if trans_w != b.layout.trans_w:
            raise ValueError(
                f"trans_w={trans_w} but the operand was made with "
                f"trans_w={b.layout.trans_w}")
    elif isinstance(b, torch.Tensor):
        if b.dim() != 3 or b.shape[0] != g:
            raise ValueError(f"mp_dot_grouped: b must be ({g}, ., .), got "
                             f"{tuple(b.shape)}")
    else:
        raise TypeError(
            f"mp_dot_grouped: unsupported operand {type(b).__name__}; b is "
            f"{_OPERANDS}")
    epilogue, extras = _build_epilogue(epilogue, activation, gate, residual,
                                       epilogue_operands, quant_in)
    extras = tuple(e.contiguous() for e in extras)
    y = _gemm(x, b, bias, extras, trans_w, epilogue, policy,
              out_dtype or policy.out, grouped=True)
    if group_sizes is not None:
        rows = torch.arange(y.shape[1], device=y.device)[None, :, None]
        sizes = group_sizes.to(device=y.device).reshape(-1, 1, 1)
        y = torch.where(rows < sizes, y, torch.zeros((), dtype=y.dtype,
                                                     device=y.device))
    return y


def _as_grouped_matmul(spec: str, n_ops: int) -> Optional[bool]:
    """Is ``spec`` a grouped matmul ``Xab,Xbc->Xac`` (any letters)?
    Returns ``trans_w`` (False for ``Xab,Xbc->Xac``, True for the
    stored-transposed ``Xab,Xcb->Xac``) or None when it is not one."""
    if n_ops != 2:
        return None
    try:
        ins, out = spec.replace(" ", "").split("->")
        a, b = ins.split(",")
    except ValueError:
        return None
    if not (len(a) == len(b) == len(out) == 3 and len(set(a)) == 3):
        return None
    if not (a[0] == b[0] == out[0] and out[1] == a[1]):
        return None
    if b[1] == a[2] and out[2] == b[2] and len({a[0], a[1], a[2], b[2]}) == 4:
        return False           # Xab,Xbc->Xac
    if b[2] == a[2] and out[2] == b[1] and len({a[0], a[1], a[2], b[1]}) == 4:
        return True            # Xab,Xcb->Xac
    return None


def mp_einsum(spec: str, *operands, policy="bf16") -> torch.Tensor:
    """Policy-aware einsum (port of ``repro.core.gemm.mp_einsum``).

    A grouped-matmul spec over float operands (``gmk,gkn->gmn`` or the
    stored-transposed ``gmk,gnk->gmn``, any letters) goes through
    :func:`mp_dot_grouped`, so it reaches grouped K1.  Anything else is a
    plain torch einsum: float operands cast to the policy's compute dtype
    (an integer operand beside them too, as jnp promotes it), the sum in
    f32, the result in the policy's output dtype (a quantized policy takes
    its bf16 sibling here).
    """
    trans_w = _as_grouped_matmul(spec, len(operands))
    if trans_w is not None and all(o.is_floating_point() for o in operands):
        return mp_dot_grouped(operands[0], operands[1], policy=policy,
                              trans_w=trans_w)
    policy = get_policy(policy)
    if policy.quantized:
        policy = get_policy("bf16")
    if any(o.is_floating_point() for o in operands):
        operands = [o.to(policy.compute).float() for o in operands]
    return torch.einsum(spec, *operands).to(policy.out)
