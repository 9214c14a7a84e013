"""Tile packing with on-the-fly transposition (port of
``repro.packing.pack``): the paper's packing pass, run once at load time.

``pack_operand`` reorders a (k, n) weight -- or an (n, k) one under
``trans_w``, transposed during the pack -- into zero-padded (bk, bn) tiles
(:class:`~repro_torch.packing.layout.PackedLayout`); a (G, ., .) expert
stack packs group by group into one grouped payload (``layout.g = G``).
A codec payload quantizes each tile symmetrically with its own f32 scale
``max(amax, 1e-8) / qmax``: int8 and int4 round half to even and clip
(int4 nibble-packs two K-adjacent values per byte, low nibble = even k),
fp8e4m3 clips to +-448 and casts.

Dispatch is by the source tensor's device: a CPU tensor runs
:func:`pack_reference`, the plain version; a CUDA tensor launches K6
(``csrc/pack.cu``), whose payload and scales are byte-identical to the
plain version's.  :func:`unpack_operand` is the inverse: a CPU payload
runs :func:`unpack_reference`, a CUDA payload launches K7 (the tile
unpacker, in the same source), bit-equal to it.

Each kernel has two designs, picked from the operands by
:func:`k6_design` and :func:`k7_design`: ``"stream"`` (16-byte vectors
in and out, a tile read once) for the aligned operands that every packed
and sparse load of the ported models gives, ``"simt"`` (the first, scalar
kernels) for the rest.  Both run the same operations on every element.

``pack_operand.launches`` counts K6 launches, ``unpack_operand.launches``
K7 launches; ``.stream_launches`` those that ran the stream design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.codecs import (
    FP8_E4M3_MAX, canonical_payload_dtype, dtype_name, torch_dtype,
)
from repro_torch.kernels import _build
from repro_torch.packing.layout import PackedLayout, PackedOperand


def _layout_for(w: torch.Tensor, bk: int, bn: int, *, trans_w: bool,
                dtype) -> PackedLayout:
    if w.dim() not in (2, 3):
        raise ValueError(f"pack_operand expects a 2-D (or grouped 3-D) "
                         f"operand, got {tuple(w.shape)}")
    k, n = w.shape[-1:-3:-1] if trans_w else w.shape[-2:]
    # Clamp blocks to the extent: a tiny operand packs as one exact tile.
    return PackedLayout(
        k=k, n=n, bk=min(int(bk), k), bn=min(int(bn), n),
        dtype=canonical_payload_dtype(dtype if dtype is not None
                                      else w.dtype),
        orig_dtype=dtype_name(w.dtype), trans_w=trans_w,
        g=w.shape[0] if w.dim() == 3 else 1)


# --- the plain version -------------------------------------------------------

def _tiles(w: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """(..., k, n) / (..., n, k) source -> zero-padded
    (..., nkb, nnb, bk, bn) tiles (a grouped stack keeps its lead axis)."""
    if layout.trans_w:
        w = w.transpose(-1, -2)
    k, n, bk, bn = layout.k, layout.n, layout.bk, layout.bn
    wp = F.pad(w, (0, layout.nnb * bn - n, 0, layout.nkb * bk - k))
    return wp.reshape(*w.shape[:-2], layout.nkb, bk, layout.nnb,
                      bn).transpose(-3, -2)


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """(..., bk, bn) int8 values in [-7, 7] -> (..., ceil(bk/2), bn) int8
    bytes: low nibble = even k, high nibble = odd k (an odd bk pads the
    last high nibble with zero)."""
    if q.shape[-2] % 2:
        q = F.pad(q, (0, 0, 0, 1))
    lo = q[..., 0::2, :].to(torch.int32)
    hi = q[..., 1::2, :].to(torch.int32)
    byte = ((hi << 4) | (lo & 0xF)) & 0xFF
    return byte.to(torch.uint8).view(torch.int8)


def unpack_nibbles(b: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: sign-extend each nibble and
    interleave back to ``rows`` logical K rows (int8)."""
    bi = b.to(torch.int32)
    lo = ((bi & 0xF) ^ 8) - 8            # sign-extend the low nibble
    hi = bi >> 4                          # arithmetic shift of the byte
    pair = torch.stack((lo, hi), dim=-2)  # (..., hk, 2, bn)
    full = pair.reshape(*b.shape[:-2], 2 * b.shape[-2], b.shape[-1])
    return full[..., :rows, :].to(torch.int8)


def _encode(tiles: torch.Tensor, layout: PackedLayout):
    """Per-tile symmetric quantization: (..., nkb, nnb, bk, bn) ->
    (payload in the codec's storage dtype, f32 scales)."""
    codec = layout.codec
    t32 = tiles.float()
    amax = t32.abs().amax(dim=(-2, -1))
    # A tensor divisor: a Python scalar on a CUDA tensor makes PyTorch
    # multiply by its reciprocal, which rounds differently from K6's and the
    # reference's division.
    scales = amax.clamp_min(1e-8) / torch.full_like(amax, codec.qmax)
    scaled = t32 / scales[..., None, None]
    if codec.integer:
        q = torch.round(scaled).clamp(-codec.qmax, codec.qmax).to(torch.int8)
        if codec.elems_per_byte > 1:
            q = pack_nibbles(q)
        return q.contiguous(), scales
    q = scaled.clamp(-FP8_E4M3_MAX, FP8_E4M3_MAX)
    return q.to(layout.storage_dtype).contiguous(), scales


def pack_reference(w: torch.Tensor, layout: PackedLayout):
    """K6's plain version: (payload, scales | None), shaped as the layout
    says (a one-group stack drops its group axis, as the reference's
    layout does)."""
    tiles = _tiles(w, layout)
    if layout.per_tile_scales:
        payload, scales = _encode(tiles, layout)
        return (payload.reshape(layout.payload_shape),
                scales.reshape(layout.scales_shape))
    return tiles.to(layout.storage_dtype).reshape(
        layout.payload_shape).contiguous(), None


def decode_payload_tiles(payload: torch.Tensor,
                         layout: PackedLayout) -> torch.Tensor:
    """Payload tiles -> per-element values before the scale (int4 nibbles
    sign-extended and interleaved back to bk rows)."""
    codec = layout.codec
    if codec is not None and codec.elems_per_byte > 1:
        return unpack_nibbles(payload, layout.bk)
    return payload


def unpack_reference(payload, scales, layout: PackedLayout, dtype):
    """K7's plain version: the dense (k, n) operand in ``dtype``, or
    (g, k, n) for a grouped payload."""
    tiles = decode_payload_tiles(payload, layout)
    if scales is not None:
        tiles = tiles.float() * scales[..., None, None]
    full = tiles.transpose(-3, -2).reshape(
        *tiles.shape[:-4], layout.nkb * layout.bk, layout.nnb * layout.bn)
    return full[..., :layout.k, :layout.n].to(torch_dtype(dtype))


# --- public API --------------------------------------------------------------

def pack_operand(w: torch.Tensor, blocks: Tuple[int, int], *,
                 trans_w: bool = False, dtype=None) -> PackedOperand:
    """Pack a (k, n) / (n, k) weight -- or a grouped (g, ., .) stack, in
    one launch -- into ``blocks = (bk, bn)`` tiles.

    ``dtype`` selects the payload: a float dtype stores cast tiles; a codec
    name (``"int8"`` / ``"int4"`` / ``"fp8e4m3"``, aliases such as
    ``"fp8"`` accepted) stores per-tile quantized tiles plus f32 scales.
    Defaults to the source dtype.
    """
    bk, bn = blocks
    layout = _layout_for(w, bk, bn, trans_w=trans_w, dtype=dtype)
    if w.device.type == "cpu":
        payload, scales = pack_reference(w, layout)
    elif w.device.type == "cuda":
        payload, scales = _launch(w, layout)
    else:
        raise ValueError(f"pack_operand: unsupported device {w.device}")
    return PackedOperand(payload, scales, layout)


def unpack_operand(p: PackedOperand, *, dtype=None) -> torch.Tensor:
    """Inverse of :func:`pack_operand`: the dense (k, n) operand ((g, k, n)
    for a grouped one).  Codec payloads dequantize per tile; float payloads
    round-trip exactly.
    ``dtype`` defaults to the payload dtype (codecs: the source dtype).
    A CPU payload runs the plain version, a CUDA one K7."""
    layout = p.layout
    if dtype is None:
        dtype = layout.orig_dtype if layout.per_tile_scales else layout.dtype
    dev = p.payload.device
    if dev.type == "cpu":
        return unpack_reference(p.payload, p.scales, layout, dtype)
    if dev.type != "cuda":
        raise ValueError(f"unpack_operand: unsupported device {dev}")
    return _launch_unpack(p, torch_dtype(dtype))


# --- the design rules --------------------------------------------------------

_SRC_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Payload codes of csrc/pack.cu: float payloads by dtype, then the codecs.
_PAYLOAD_CODES = {"float32": 0, "bfloat16": 1, "int8": 2, "int4": 3,
                  "fp8e4m3": 4}
# Payload bytes a tile column takes in one payload row (int4: a byte holds
# rows 2r and 2r + 1).
_PAYLOAD_COLUMN_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1, "int4": 1,
                         "fp8e4m3": 1}
# The stream packer holds a tile in shared memory as f32, rows rounded up to
# 32 floats: at most 128 x 128 of them (64 KiB).
K6_STREAM_MAX_FLOATS = 128 * 128
# A grid's y (tile rows) and z (groups) extents.
_GRID_YZ = 65535
# K7's output dtypes.
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def k6_design(w: torch.Tensor, layout: PackedLayout) -> str:
    """The K6 kernel that packs ``w`` into ``layout`` on the card:
    ``"stream"`` (``csrc/pack.cu::pack_stream_kernel``) for an f32 or bf16
    source that is contiguous, 16-byte aligned and non-empty, whose
    contiguous axis (n, or k under ``trans_w``) and the tile's span along
    it (bn, or bk) are multiples of 16 bytes, whose payload rows (bn
    columns) are multiples of 16 bytes, and whose tile fits the design's
    shared memory (bk x bn rounded up to 32 at most 128 x 128) --
    every weight that ``packing/params.py::pack_params`` and
    ``sparse/sparsify.py`` pack for the ported models at their default
    blocks, edge tiles included (an odd bk of an int4 payload too: the
    last high nibble is zero); else ``"simt"`` (``pack_kernel``).  A
    rule on what the operands are, not a fallback: a failed build or
    launch raises."""
    if w.dtype not in _SRC_CODES or layout.dtype not in _PAYLOAD_CODES:
        return "simt"
    esz = w.element_size()
    pitch, span = ((layout.k, layout.bk) if layout.trans_w
                   else (layout.n, layout.bn))
    if (not w.is_contiguous() or w.data_ptr() % 16 or not w.numel()
            or (pitch * esz) % 16 or (span * esz) % 16
            or (layout.bn * _PAYLOAD_COLUMN_BYTES[layout.dtype]) % 16
            or layout.bk * -(-layout.bn // 32) * 32 > K6_STREAM_MAX_FLOATS
            or layout.nkb > _GRID_YZ or layout.g > _GRID_YZ):
        return "simt"
    return "stream"


def k7_design(p: PackedOperand, dtype) -> str:
    """The K7 kernel that unpacks ``p`` into ``dtype`` on the card:
    ``"stream"`` (``csrc/pack.cu::unpack_stream_kernel``) for an f32 or
    bf16 output of a contiguous, 16-byte-aligned, non-empty payload whose
    tile rows and whose logical rows (bn and n) are multiples of 8 columns
    -- every packed weight of the ported models at their default blocks,
    which ``core/gemm.py`` unpacks in a packed weight's backward and in a
    float payload's forward under the int8 policy; else ``"simt"``
    (``unpack_kernel``).  A rule on what the operands are, not a
    fallback."""
    layout, payload = p.layout, p.payload
    if (torch_dtype(dtype) not in _OUT_CODES
            or layout.dtype not in _PAYLOAD_CODES
            or not payload.is_contiguous() or payload.data_ptr() % 16
            or not payload.numel() or layout.bn % 8 or layout.n % 8
            or layout.nkb > _GRID_YZ or layout.g > _GRID_YZ):
        return "simt"
    return "stream"


# --- K6 launch ---------------------------------------------------------------


def _launch(w: torch.Tensor, layout: PackedLayout):
    if w.dtype not in _SRC_CODES:
        raise NotImplementedError(f"pack kernel source dtype {w.dtype} "
                                  "(takes float32 or bfloat16)")
    if layout.dtype not in _PAYLOAD_CODES:
        raise NotImplementedError(f"pack kernel payload {layout.dtype!r}")
    if not w.is_contiguous():
        raise ValueError("pack_operand: the source must be contiguous")
    payload = torch.empty(layout.payload_shape, dtype=layout.storage_dtype,
                          device=w.device)
    scales = (torch.empty(layout.scales_shape, dtype=torch.float32,
                          device=w.device)
              if layout.per_tile_scales else None)
    if payload.numel() == 0:
        return payload, scales
    lib = _lib()
    stream = k6_design(w, layout) == "stream"
    rc = (lib.pack_stream_launch if stream else lib.pack_launch)(
        w.data_ptr(), payload.data_ptr(),
        scales.data_ptr() if scales is not None else None,
        _SRC_CODES[w.dtype], _PAYLOAD_CODES[layout.dtype],
        layout.g, layout.k, layout.n, layout.bk, layout.bn,
        int(layout.trans_w),
        _build.current_stream(w))
    if rc != 0:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {rc} "
                           f"({lib.pack_error_string(rc).decode()})")
    pack_operand.launches += 1
    pack_operand.stream_launches += int(stream)
    return payload, scales


pack_operand.launches = 0
pack_operand.stream_launches = 0


# --- K7 launch ---------------------------------------------------------------


def _launch_unpack(p: PackedOperand, dtype: torch.dtype) -> torch.Tensor:
    layout = p.layout
    if dtype not in _OUT_CODES:
        raise NotImplementedError(f"unpack kernel output dtype {dtype} "
                                  "(takes float32 or bfloat16)")
    if layout.dtype not in _PAYLOAD_CODES:
        raise NotImplementedError(f"unpack kernel payload {layout.dtype!r}")
    payload = p.payload
    if (tuple(payload.shape) != layout.payload_shape
            or payload.dtype != layout.storage_dtype
            or not payload.is_contiguous()):
        raise ValueError(f"unpack_operand: the payload must be a contiguous "
                         f"{layout.payload_shape} {layout.storage_dtype} "
                         f"tensor, got {tuple(payload.shape)} {payload.dtype}")
    scales = p.scales
    if layout.per_tile_scales:
        if (scales is None or scales.device != payload.device
                or scales.dtype != torch.float32
                or scales.numel() != layout.g * layout.nkb * layout.nnb):
            raise ValueError("unpack_operand: a codec payload needs its f32 "
                             "per-tile scales on the payload's device")
        scales = scales.contiguous()
    shape = ((layout.g,) if layout.g != 1 else ()) + (layout.k, layout.n)
    out = torch.empty(shape, dtype=dtype, device=payload.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = k7_design(p, dtype) == "stream"
    rc = (lib.unpack_stream_launch if stream else lib.unpack_launch)(
        payload.data_ptr(),
        scales.data_ptr() if layout.per_tile_scales else None,
        out.data_ptr(), _PAYLOAD_CODES[layout.dtype], _OUT_CODES[dtype],
        layout.g, layout.k, layout.n, layout.bk, layout.bn,
        _build.current_stream(payload))
    if rc != 0:
        raise RuntimeError(f"unpack kernel launch failed: CUDA error {rc} "
                           f"({lib.pack_error_string(rc).decode()})")
    unpack_operand.launches += 1
    unpack_operand.stream_launches += int(stream)
    return out


unpack_operand.launches = 0
unpack_operand.stream_launches = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pack_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    lib.pack_launch.restype = i
    lib.pack_stream_launch.argtypes = lib.pack_launch.argtypes
    lib.pack_stream_launch.restype = i
    lib.unpack_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.unpack_launch.restype = i
    lib.unpack_stream_launch.argtypes = lib.unpack_launch.argtypes
    lib.unpack_stream_launch.restype = i
    lib.pack_error_string.argtypes = [i]
    lib.pack_error_string.restype = ctypes.c_char_p
    return lib
