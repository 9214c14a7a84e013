"""Hardware constants of the H100 target, for the block planner
(``core/blocking.py``) and the tuner's modeled mode (port of
``repro.core.constants``, which describes a TPU; the port holds no TPU
spec).

The numbers are NVIDIA's H100 SXM5 80GB data sheet at its 700 W limit
(dense rates, no sparsity) and the Hopper tuning guide's limits: a card set
below 700 W runs slower under load than these peaks say.  On the card the
spec is read from ``torch.cuda.get_device_properties``
(:func:`device_spec`): its ``name`` carries the SM count, and plan-cache
keys carry the name (``tuning/plan_cache.py::make_key``), so a card with
another SM count never reads plans tuned for this one.  On the CPU the
SXM5 default (:data:`H100_SXM5`) stands in.
"""
from __future__ import annotations

import dataclasses
import functools

# The wgmma designs' tile (csrc/mpgemm_wgmma.cuh): a stage is one 128-byte
# swizzled row of K (32 f32, 64 bf16, 128 int8 values), BN columns wide,
# BM = 64 or 128 rows (one or two consumer warpgroups).
TMA_ROW_BYTES = 128
WGMMA_M = 64
WGMMA_BN = 128
WGMMA_BK, WGMMA_BK_INT8, WGMMA_BK_F32 = (TMA_ROW_BYTES // 2,
                                         TMA_ROW_BYTES,
                                         TMA_ROW_BYTES // 4)
# The payload tile K2's and K3's wgmma designs read: 128 rows of K, BN
# columns (packing/params.py packs in it).
WGMMA_PAYLOAD_TILE = (128, WGMMA_BN)
# The SMs of an H100 SXM5, split-K's target.
H100_SMS = 132
# The shared memory a block may take on sm_90 (227 KB), which the wgmma
# designs' ring is sized against at compile time (Cfg::kStages).
SMEM_BLOCK_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    # Compute: dense peaks, FLOP/s (OP/s for int8) per card.
    peak_flops_bf16: float   # tensor cores, bf16 in, f32 sums
    peak_flops_tf32: float   # tensor cores, tf32 in (one of 3xTF32's terms)
    peak_flops_fp32: float   # f32 FMA on the CUDA cores
    peak_ops_int8: float     # tensor cores, int8 in, int32 sums
    # Memory.
    hbm_bytes: int
    hbm_bw: float            # bytes/s
    l2_bytes: int
    smem_bytes: int          # shared memory one block may take (opt-in)
    sms: int = H100_SMS
    # Tiling granularity of wgmma and TMA.
    wgmma_m: int = WGMMA_M
    tma_row_bytes: int = TMA_ROW_BYTES
    wgmma_bn: int = WGMMA_BN


H100_SXM5 = HardwareSpec(
    name=f"h100_{H100_SMS}sm",
    peak_flops_bf16=989e12,
    peak_flops_tf32=495e12,
    peak_flops_fp32=67e12,
    peak_ops_int8=1979e12,
    hbm_bytes=80 * 10**9,
    hbm_bw=3.35e12,
    l2_bytes=50 * 2**20,
    smem_bytes=SMEM_BLOCK_BYTES,
)

# Default spec used across the port where no card is asked.
DEFAULT_HW = H100_SXM5


@functools.lru_cache(maxsize=None)
def device_spec(index: int) -> HardwareSpec:
    """The spec of CUDA device ``index``: the SXM5 data sheet's rates with
    the card's own SM count, memory and per-block shared memory.  Its name
    is ``h100_<SMs>sm`` on a Hopper card (compute capability 9.x),
    ``sm<major><minor>_<SMs>sm`` on another."""
    import torch
    p = torch.cuda.get_device_properties(index)
    sms = p.multi_processor_count
    family = "h100" if p.major == 9 else f"sm{p.major}{p.minor}"
    return dataclasses.replace(
        H100_SXM5, name=f"{family}_{sms}sm", sms=sms,
        hbm_bytes=int(p.total_memory),
        smem_bytes=int(getattr(p, "shared_memory_per_block_optin",
                               H100_SXM5.smem_bytes)))
