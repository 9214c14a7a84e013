"""Packed-operand layout metadata and :class:`PackedOperand` (port of
``repro.packing.layout``).

    logical weight  w[k, n]   (or w[n, k] under ``trans_w``)
        |  pack (packing/pack.py): tile, pad edges with ZEROS,
        |  resolve the transpose, optionally per-tile quantize
        v
    payload[(g,) nkb, nnb, tk, bn]
    scales [(g,) nkb, nnb] f32 (quantized codecs)

``tk`` is the PHYSICAL tile row count: ``bk`` for byte-or-wider payloads,
``ceil(bk / 2)`` for int4.  Every (bk, bn) tile is contiguous in memory,
so the packed GEMM (K2) reads tile (kk, j) at a known offset.  A grouped
operand (an MoE expert stack, ``g`` > 1) leads with its group axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.codecs import (
    dtype_bits, dtype_name, get_codec, storage_dtype, torch_dtype,
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static description of one packed operand (same fields as the
    reference's).

    ``k``/``n`` are the LOGICAL GEMM dims with a ``trans_w`` source's
    transpose already resolved; ``dtype`` is the payload dtype (a float
    dtype name or a codec from ``core.codecs``); ``orig_dtype`` the
    source's dtype; ``bits_per_element`` the logical storage width,
    derived from ``dtype`` when left at 0.
    """

    k: int
    n: int
    bk: int
    bn: int
    dtype: str
    orig_dtype: str
    trans_w: bool = False
    g: int = 1
    bits_per_element: int = 0

    def __post_init__(self):
        if self.bits_per_element == 0:
            object.__setattr__(self, "bits_per_element",
                               dtype_bits(self.dtype))

    @property
    def nkb(self) -> int:
        return _cdiv(self.k, self.bk)

    @property
    def nnb(self) -> int:
        return _cdiv(self.n, self.bn)

    @property
    def codec(self):
        """The :class:`~repro_torch.core.codecs.PayloadCodec`, or None."""
        return get_codec(self.dtype)

    @property
    def per_tile_scales(self) -> bool:
        return self.codec is not None

    @property
    def storage_dtype(self) -> torch.dtype:
        """Torch dtype of the payload tensor (int8 bytes for int4 nibbles,
        float8_e4m3fn for fp8e4m3)."""
        return storage_dtype(self.dtype)

    @property
    def kernel_native(self) -> bool:
        """Always true in the port: torch has float8_e4m3fn natively."""
        return True

    @property
    def payload_tile(self) -> Tuple[int, int]:
        """PHYSICAL payload dims of one (bk, bn) logical tile."""
        codec = self.codec
        rows = codec.payload_rows(self.bk) if codec is not None else self.bk
        return (rows, self.bn)

    @property
    def payload_shape(self) -> Tuple[int, ...]:
        base = (self.nkb, self.nnb) + self.payload_tile
        return (self.g,) + base if self.g != 1 else base

    @property
    def scales_shape(self) -> Optional[Tuple[int, ...]]:
        if not self.per_tile_scales:
            return None
        base = (self.nkb, self.nnb)
        return (self.g,) + base if self.g != 1 else base

    @property
    def tag(self) -> str:
        """Layout tag: the packed-B access pattern (blocks and payload
        dtype), independent of the resolved-away source transpose."""
        return f"packB{self.bk}x{self.bn}{self.dtype}"

    def describe(self) -> str:
        shape = f"{self.k}x{self.n}"
        if self.g != 1:
            shape = f"{self.g}x{shape}"
        t = "ᵀ" if self.trans_w else ""
        return (f"PackedLayout[{shape}{t} {self.orig_dtype}->{self.dtype} "
                f"tiles=({self.bk},{self.bn})x({self.nkb},{self.nnb})]")


class PackedOperand:
    """A pre-packed GEMM operand: payload + optional per-tile scales +
    layout.  ``mp_dot`` and ``mpgemm`` dispatch on the type."""

    __slots__ = ("payload", "scales", "layout")

    def __init__(self, payload: torch.Tensor,
                 scales: Optional[torch.Tensor], layout: PackedLayout):
        self.payload = payload
        self.scales = scales
        self.layout = layout

    @property
    def shape(self) -> Tuple[int, ...]:
        """The LOGICAL (transpose-resolved) operand shape (k, n)."""
        base = (self.layout.k, self.layout.n)
        return (self.layout.g,) + base if self.layout.g != 1 else base

    @property
    def dtype(self) -> torch.dtype:
        """Torch dtype of the payload TENSOR (the logical format is
        ``layout.dtype``)."""
        return self.layout.storage_dtype

    @property
    def nbytes(self) -> int:
        total = self.payload.numel() * self.payload.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return total

    def astype(self, dtype) -> "PackedOperand":
        """Payload cast for float payloads (no-op when the dtype already
        matches or the payload is a codec)."""
        dtype = torch_dtype(dtype)
        if self.layout.per_tile_scales or self.payload.dtype == dtype:
            return self
        layout = dataclasses.replace(self.layout, dtype=dtype_name(dtype),
                                     bits_per_element=0)
        return PackedOperand(self.payload.to(dtype), None, layout)

    def to(self, device) -> "PackedOperand":
        """The same operand with payload and scales on ``device``."""
        return PackedOperand(
            self.payload.to(device),
            None if self.scales is None else self.scales.to(device),
            self.layout)

    def __repr__(self) -> str:
        return self.layout.describe().replace("PackedLayout", "PackedOperand")


def is_packed(w) -> bool:
    return isinstance(w, PackedOperand)
