"""Payload codecs -- the precision ladder's storage formats (own copy of
``repro.core.codecs``).

A precision is one :class:`PayloadCodec`: the dtype string stored in a
``PackedLayout.dtype``, its bits per element (int4 packs two elements per
storage byte), the torch dtype of the payload tensor and the symmetric
quantization range (``scale = amax / qmax``).

``int8``
    One byte per element, per-tile scale ``amax / 127``.
``int4``
    Two elements (nibbles) per byte along the tile's K axis, per-tile scale
    ``amax / 7``.
``fp8e4m3``
    ``torch.float8_e4m3fn`` storage with a per-tile ``amax / 448`` scale
    and a saturating cast (e4m3fn has no inf; values clip to +-448).

PyTorch has ``float8_e4m3fn`` natively, so the reference's emulated e4m3
grid has no counterpart here and every codec is ``kernel_native``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

# e4m3fn: max finite = 1.75 * 2**8 = 448 (no inf encoding).
FP8_E4M3_MAX = 448.0

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


@dataclasses.dataclass(frozen=True)
class PayloadCodec:
    """One storage format for packed weight payloads."""

    name: str                  # the PackedLayout.dtype string
    bits: int                  # logical bits per weight element
    storage: str               # dtype name of the payload tensor
    qmax: float                # symmetric quant range: scale = amax / qmax
    integer: bool              # int-valued payload (int dot + scale)
    kernel_native: bool = True

    @property
    def elems_per_byte(self) -> int:
        return max(1, 8 // self.bits)

    def payload_rows(self, bk: int) -> int:
        """Physical payload rows storing ``bk`` logical K rows."""
        e = self.elems_per_byte
        return (bk + e - 1) // e


CODECS: Dict[str, PayloadCodec] = {
    "int8": PayloadCodec("int8", 8, "int8", 127.0, integer=True),
    "int4": PayloadCodec("int4", 4, "int8", 7.0, integer=True),
    "fp8e4m3": PayloadCodec("fp8e4m3", 8, "float8_e4m3fn", FP8_E4M3_MAX,
                            integer=False),
}

# CLI spellings (launch/serve.py --pack-format) -> codec names.
_ALIASES = {"fp8": "fp8e4m3", "float8_e4m3fn": "fp8e4m3",
            "float8": "fp8e4m3", "e4m3": "fp8e4m3"}


def dtype_name(dtype) -> str:
    """The canonical name of a torch dtype or dtype string (``"bfloat16"``
    for ``torch.bfloat16``), as the reference's ``str(jnp.dtype(.))``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    name = str(dtype)
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; known: "
                         f"{sorted(_TORCH_DTYPES)}")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a dtype name (or a torch dtype, returned)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[dtype_name(dtype)]


def get_codec(dtype) -> Optional[PayloadCodec]:
    """The codec for a dtype string (aliases resolve), or None for plain
    (float) dtypes."""
    if not isinstance(dtype, str):
        return None
    return CODECS.get(_ALIASES.get(dtype, dtype))


def canonical_payload_dtype(dtype) -> str:
    """Normalize a payload-dtype spelling: codec names and their aliases
    pass through canonically; everything else resolves to a dtype name."""
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name in CODECS:
            return name
    return dtype_name(dtype)


def dtype_bits(dtype) -> int:
    """Logical bits per element: codec strings use the table, plain dtypes
    their item size."""
    codec = get_codec(dtype)
    if codec is not None:
        return codec.bits
    return torch_dtype(dtype).itemsize * 8


def dtype_bytes(dtype) -> float:
    """Bytes per element; fractional for sub-byte codecs (int4 -> 0.5)."""
    bits = dtype_bits(dtype)
    return bits // 8 if bits % 8 == 0 else bits / 8


def storage_dtype(dtype) -> torch.dtype:
    """Torch dtype of the payload tensor holding elements of ``dtype``."""
    codec = get_codec(dtype)
    return torch_dtype(codec.storage if codec is not None else dtype)
