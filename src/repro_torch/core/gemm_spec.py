"""GemmSpec / EpilogueSpec and the epilogue registry (port of
``repro.core.gemm_spec``).

:class:`GemmSpec` names one GEMM shape family (2-D vs grouped, dense vs
pre-packed or tile-sparse B, transposition flags, output dtype).
:class:`EpilogueSpec` names what happens to the f32 accumulator after the K
loop: scalar dequant, alpha, bias, a registry-selected tail (activation,
gated activation, residual add) and beta·C.

:func:`apply_epilogue` is the single implementation of the epilogue
semantics on tensors; the plain GEMM (``kernels/mpgemm.py``) calls it, and
the CUDA kernel's epilogue repeats it in the same order.  Each registered
family also carries its backward rule (:func:`epilogue_bwd`, with
:func:`epilogue_needs_pre` saying whether it needs the recomputed pre-tail
value), which ``core/gemm.py``'s autograd function applies.  The port
registers ``linear``, ``gated``, ``residual`` and the two pre-stage
families ``quant_in`` and ``quant_in_residual`` (per-token int8
quantization of X before the GEMM, its per-row dequant in the tail).

An int32 accumulator with no scale (an int8 x int8 product under the
op-level API) keeps the reference's integer epilogue: alpha, the bias and
beta·C are cast to int32 -- truncated toward zero, so ``alpha=0.5`` gives
zeros, as in the reference -- relu keeps it in int32, the tanh GELU
turns it into f32, and silu raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact
    # erf form -- the port must ask for tanh explicitly.
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}


def _has_act(ep: "EpilogueSpec") -> bool:
    return ep.activation not in (None, "none")


# --- the fused-epilogue registry ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpilogueDef:
    """One registered epilogue family: ``tail(ep, acc, extras)`` maps the
    post-bias accumulator to the output block; ``extras`` is a dict of the
    entry's named operands.  ``bwd(ep, z, extras, dy)`` returns ``(dz,
    dextras)``, the cotangent flowing back into the GEMM (pre-tail) and
    those of the external extra operands; ``z`` is the recomputed pre-tail
    value (f32) when ``needs_pre(ep)`` holds, else None.

    ``pre(ep, x)``, when set, runs on X before the launch and returns
    ``(x', internal_extras)``; the internal extras (named by ``internal``,
    the leading entries of ``extra_operands``) are prepended to the
    caller's.  ``row_operands`` names extras shaped (M, 1) per row instead
    of like the output."""

    kind: str
    extra_operands: Tuple[str, ...]
    tail: Callable
    bwd: Callable
    needs_pre: Callable
    pre: Optional[Callable] = None
    internal: Tuple[str, ...] = ()
    row_operands: Tuple[str, ...] = ()

    @property
    def external_operands(self) -> Tuple[str, ...]:
        """The extras a caller passes (``extra_operands`` less the
        pre-stage's ``internal`` ones)."""
        return tuple(nm for nm in self.extra_operands
                     if nm not in self.internal)


_EPILOGUES: Dict[str, EpilogueDef] = {}


def register_epilogue(kind: str, *, extra_operands: Tuple[str, ...] = (),
                      bwd: Callable, needs_pre: Callable,
                      pre: Optional[Callable] = None,
                      internal: Tuple[str, ...] = (),
                      row_operands: Tuple[str, ...] = ()):
    """Register a fused-epilogue family under ``kind`` (decorator)."""
    def deco(tail: Callable) -> Callable:
        if kind in _EPILOGUES:
            raise ValueError(f"epilogue {kind!r} already registered")
        if not set(internal) <= set(extra_operands):
            raise ValueError(f"internal operands {internal} must be a "
                             f"subset of extra_operands {extra_operands}")
        _EPILOGUES[kind] = EpilogueDef(
            kind, tuple(extra_operands), tail, bwd, needs_pre, pre,
            tuple(internal), tuple(row_operands))
        return tail
    return deco


def get_epilogue(kind: str) -> EpilogueDef:
    try:
        return _EPILOGUES[kind]
    except KeyError:
        raise ValueError(
            f"unknown epilogue kind {kind!r}; registered: "
            f"{sorted(_EPILOGUES)}") from None


# --- specs -------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpilogueSpec:
    """Everything applied to the accumulator before it is stored.

    Order of operations (``apply_epilogue``)::

        acc = acc(f32) * scale        # scalar dequant, when a scale is fed
        acc = alpha * acc
        acc = acc + bias
        acc = tail(acc)               # registry: act(acc) | act(acc)·g | ...
        acc = acc + beta * c
    """

    kind: str = "linear"
    activation: Optional[str] = None
    alpha: float = 1.0
    beta: float = 0.0

    def __post_init__(self):
        get_epilogue(self.kind)  # raises on unknown kinds
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; valid: "
                f"{sorted(k for k in ACTIVATIONS if k)}")

    @property
    def extra_operands(self) -> Tuple[str, ...]:
        return get_epilogue(self.kind).extra_operands

    @property
    def tag(self) -> str:
        """Plan-cache namespace tag (``tuning/plan_cache.py::make_key(...,
        epilogue=...)``), the reference's: empty for the ``linear`` family,
        the kind (and its activation) for a fusion, whose extra streamed
        operands move the measured optimum."""
        if self.kind == "linear":
            return ""
        if self.activation in (None, "none"):
            return self.kind
        return f"{self.kind}-{self.activation}"


@dataclasses.dataclass(frozen=True)
class GemmSpec:
    """Static description of one GEMM instance family (same fields as the
    reference; the port's kernel takes the dense 2-D subset so far)."""

    grouped: bool = False
    packed: bool = False
    sparse: bool = False
    trans_a: bool = False
    trans_b: bool = False
    out_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.packed and self.sparse:
            raise ValueError("packed and sparse B are mutually exclusive")
        if (self.packed or self.sparse) and self.trans_b:
            raise ValueError(
                "packed/sparse B has its transpose resolved at pack time")


# --- the one epilogue implementation -----------------------------------------

def apply_epilogue(ep: EpilogueSpec, acc, *, bias=None, scale=None, c=None,
                   extras=()):
    """Apply ``ep`` to an accumulator tensor, 2-D (M, N) or grouped
    (G, M, N): f32, or int32 for an int8 product.

    ``extras`` is a tuple in the registry entry's ``extra_operands`` order,
    each shaped like ``acc`` (a row operand (M, 1)); ``c`` must broadcast
    against ``acc``; ``scale`` is a scalar.  ``bias`` is one row per
    group: (N,) against a 2-D ``acc``, (G, N) against a grouped one (or
    anything that broadcasts, such as a shared (N,)).  Each scalar takes
    the accumulator's dtype, as ``jnp.asarray(x, acc.dtype)`` does in the
    reference: against an int32 accumulator alpha and beta truncate toward
    zero.
    """
    ed = get_epilogue(ep.kind)
    if scale is not None:
        acc = acc.float() * scale
    if ep.alpha != 1.0:
        acc = acc * _scalar(ep.alpha, acc)
    if bias is not None:
        if bias.dim() == acc.dim() - 1:
            bias = bias.unsqueeze(-2)      # a row per group, over M
        acc = acc + bias.to(acc.dtype)
    acc = ed.tail(ep, acc, dict(zip(ed.extra_operands, extras)))
    if ep.beta != 0.0:
        if c is None:
            raise ValueError("beta != 0 requires c")
        acc = acc + _scalar(ep.beta, acc) * c.to(acc.dtype)
    return acc


def _scalar(x: float, acc):
    """``x`` in ``acc``'s dtype: truncated toward zero for an integer
    accumulator (``jnp.asarray(x, jnp.int32)``)."""
    return x if acc.is_floating_point() else int(x)


# Activations an int32 accumulator takes, as the reference's do: relu keeps
# it in int32, the tanh GELU returns f32 (the rest of the epilogue then
# runs in f32), and silu raises TypeError.
INT_ACTIVATIONS = (None, "none", "relu", "gelu")


def _activate(ep, acc):
    """``ep``'s activation of the accumulator; an integer one takes only
    :data:`INT_ACTIVATIONS`."""
    if not acc.is_floating_point():
        if ep.activation not in INT_ACTIVATIONS:
            raise TypeError(
                f"activation {ep.activation!r} does not take an integer "
                "accumulator; pass a scale to dequantize first")
        if ep.activation == "gelu":
            acc = acc.float()
    return ACTIVATIONS[ep.activation](acc)


def epilogue_bwd(ep: EpilogueSpec, z, extras, dy):
    """Cotangents through the registry tail: ``(dz, dextras)``.

    ``dy`` must be f32; ``z`` is the recomputed pre-tail value (f32) when
    the entry's ``needs_pre`` demanded it, else None.  Bias, alpha and
    scale cotangents are the caller's (dbias = the row sum of dz).
    """
    return get_epilogue(ep.kind).bwd(ep, z, extras, dy)


def epilogue_needs_pre(ep: EpilogueSpec) -> bool:
    """Does the backward rule need the recomputed pre-tail value?"""
    return bool(get_epilogue(ep.kind).needs_pre(ep))


# --- operand -> spec resolution ----------------------------------------------

def infer_epilogue_kind(named: dict) -> str:
    """The registry kind whose ``extra_operands`` exactly match the non-None
    ``named`` operands (``{}`` / all-None -> ``linear``)."""
    present = frozenset(k for k, v in named.items() if v is not None)
    if not present:
        return "linear"
    for kind, ed in _EPILOGUES.items():
        if ed.pre is not None:
            continue      # pre-stage kinds (quant_in) are explicit-only
        if present == frozenset(ed.extra_operands):
            return kind
    raise ValueError(
        f"operands {sorted(present)} are not consumed together by any "
        f"registered epilogue; registered: "
        f"{ {k: v.extra_operands for k, v in _EPILOGUES.items()} }")


def collect_extras(ep: EpilogueSpec, named: dict) -> tuple:
    """``named`` operands ordered per the registry entry, with presence and
    leftover validation; only the entry's external operands (the
    pre-stage makes the internal ones)."""
    wanted = get_epilogue(ep.kind).external_operands
    extras = []
    for nm in wanted:
        if named.get(nm) is None:
            raise ValueError(f"epilogue {ep.kind!r} requires operand {nm!r}")
        extras.append(named[nm])
    for nm, v in named.items():
        if v is not None and nm not in wanted:
            raise ValueError(
                f"operand {nm!r} is not consumed by epilogue {ep.kind!r}")
    return tuple(extras)


def resolve_epilogue(named: dict, *, epilogue: Optional[EpilogueSpec] = None,
                     activation=None, alpha: float = 1.0, beta: float = 0.0):
    """(EpilogueSpec, ordered extras) from named fusion operands: an
    explicit ``epilogue`` wins; otherwise the kind is inferred from which
    operands are present."""
    if epilogue is None:
        epilogue = EpilogueSpec(kind=infer_epilogue_kind(named),
                                activation=activation, alpha=float(alpha),
                                beta=float(beta))
    elif activation is not None:
        raise ValueError(
            "pass the activation inside the EpilogueSpec OR as the "
            "activation kwarg, not both")
    return epilogue, collect_extras(epilogue, named)


# --- built-in epilogue families ----------------------------------------------

def _act_vjp(ep, z, dy):
    """(act(z), dy · act'(z)) by autograd of the forward activation."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        a = ACTIVATIONS[ep.activation](zz)
        (dz,) = torch.autograd.grad(a, zz, dy)
    return a.detach(), dz


def _linear_bwd(ep, z, extras, dy):
    return (_act_vjp(ep, z, dy)[1] if _has_act(ep) else dy), ()


@register_epilogue("linear", bwd=_linear_bwd, needs_pre=_has_act)
def _linear_tail(ep, acc, extras):
    """act(acc) — the classic BLAS-plus-activation epilogue."""
    return _activate(ep, acc)


def _gated_bwd(ep, z, extras, dy):
    g = extras[0]
    a_z, dz = _act_vjp(ep, z, dy * g.to(dy.dtype))
    return dz, ((dy * a_z.to(dy.dtype)).to(g.dtype),)


@register_epilogue("gated", extra_operands=("gate",), bwd=_gated_bwd,
                   needs_pre=lambda ep: True)
def _gated_tail(ep, acc, extras):
    """act(acc) · g — SwiGLU/GeGLU gating fused into the gate GEMM's store;
    the gate (the bf16 output of the up projection under bf16) is widened
    to f32 first."""
    return _activate(ep, acc) * extras["gate"].to(acc.dtype)


def _residual_bwd(ep, z, extras, dy):
    dz = _act_vjp(ep, z, dy)[1] if _has_act(ep) else dy
    return dz, (dy.to(extras[0].dtype),)


@register_epilogue("residual", extra_operands=("residual",),
                   bwd=_residual_bwd, needs_pre=_has_act)
def _residual_tail(ep, acc, extras):
    """act(acc) + r — the transformer residual add riding the GEMM's store,
    with the residual widened to f32."""
    return _activate(ep, acc) + extras["residual"].to(acc.dtype)


def _quant_pre(ep, x):
    """Per-token (per-row) dynamic int8 quantization of X, the pre-stage
    of the ``quant_in`` families: ``row_scale = max(amax, 1e-8) / 127``
    per row, ``q = clip(round(x / row_scale), -127, 127)`` in f32,
    rounding half to even.  -> (int8 q, ((..., M, 1) f32 row scales,)).
    Both divisions are IEEE divisions by tensors, as in
    ``core/policy.py::quantize_per_tensor``."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    row_scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(xf / row_scale).clamp(-127, 127)
    return q.to(torch.int8), (row_scale,)


def _quant_in_bwd(ep, z, extras, dy):
    # Straight-through: the rounding and clipping are ignored; z is the
    # recomputed float pre-tail GEMM.
    return (_act_vjp(ep, z, dy)[1] if _has_act(ep) else dy), ()


@register_epilogue("quant_in", extra_operands=("row_scale",),
                   internal=("row_scale",), row_operands=("row_scale",),
                   pre=_quant_pre, bwd=_quant_in_bwd, needs_pre=_has_act)
def _quant_in_tail(ep, acc, extras):
    """act(acc · row_scale) -- the per-row dequant of per-token activation
    quantization, in f32."""
    rs = extras["row_scale"].float()
    return ACTIVATIONS[ep.activation](acc.float() * rs)


def _quant_in_residual_bwd(ep, z, extras, dy):
    dz = _act_vjp(ep, z, dy)[1] if _has_act(ep) else dy
    return dz, (dy.to(extras[0].dtype),)


@register_epilogue("quant_in_residual",
                   extra_operands=("row_scale", "residual"),
                   internal=("row_scale",), row_operands=("row_scale",),
                   pre=_quant_pre, bwd=_quant_in_residual_bwd,
                   needs_pre=_has_act)
def _quant_in_residual_tail(ep, acc, extras):
    """act(acc · row_scale) + r -- the quant_in tail with the residual
    add."""
    rs = extras["row_scale"].float()
    out = ACTIVATIONS[ep.activation](acc.float() * rs)
    return out + extras["residual"].to(out.dtype)


LINEAR = EpilogueSpec()
