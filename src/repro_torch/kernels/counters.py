"""Every kernel wrapper's launch counts as one flat dict.

Each wrapper adds one to its counts where it launches its kernel (module
docstrings of ``kernels/mpgemm.py``, ``kernels/flash_attention.py`` and
``packing/pack.py``).  :func:`launch_counts` reads them all by name:

* ``k1`` ... ``k7``: the launches of each kernel (``k1g``, ``k2g``,
  ``k3g``: the grouped wrappers);
* ``<k>_ta`` / ``<k>_tb``: K1's, K2's and K3's ``trans_a`` launches and
  K1's ``trans_b`` ones;
* ``<k>_wgmma``, ``<k>_tf32x3``, ``<k>_fma``, ``<k>_split``,
  ``<k>_stream``: the launches that ran that design (K1, K2, K3 wgmma; K1
  f32 on the tensor cores; K1 f32 on the CUDA cores' FMA; K4's and K5's
  wgmma and split designs; K4's f32 design on the tensor cores; K6's and
  K7's stream designs).

A captured CUDA graph launches its kernels without their wrappers, so
whoever captures one takes the counts' delta over the capture
(:func:`count_delta`), rolls them back by it and adds it on each replay
(:func:`add_launch_counts`): the counts stay launches executed
(``core/cuda_graphs.py::CapturedStep`` does).
"""
from __future__ import annotations

from typing import Dict, Tuple


def wrappers() -> dict:
    """The counted wrappers by kernel: ``k1`` (``mpgemm``), ``k1g``
    (``mpgemm_grouped``), ``k2``/``k2g`` (packed), ``k3``/``k3g``
    (tile-sparse), ``k4`` (``flash_attention``), ``k5``
    (``paged_flash_attention``), ``k6`` (``pack_operand``), ``k7``
    (``unpack_operand``)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, paged_flash_attention,
    )
    from repro_torch.kernels.mpgemm import (
        mpgemm, mpgemm_grouped, mpgemm_packed, mpgemm_packed_grouped,
        mpgemm_sparse, mpgemm_sparse_grouped,
    )
    from repro_torch.packing.pack import pack_operand, unpack_operand
    return dict(k1=mpgemm, k1g=mpgemm_grouped, k2=mpgemm_packed,
                k2g=mpgemm_packed_grouped, k3=mpgemm_sparse,
                k3g=mpgemm_sparse_grouped, k4=flash_attention,
                k5=paged_flash_attention, k6=pack_operand, k7=unpack_operand)


# The variant and design counts of each wrapper: (suffix, attribute).
_EXTRA = {
    "k1": (("ta", "trans_a_launches"), ("tb", "trans_b_launches"),
           ("wgmma", "wgmma_launches"), ("tf32x3", "tf32x3_launches"),
           ("fma", "fma_launches")),
    "k2": (("ta", "trans_a_launches"), ("wgmma", "wgmma_launches")),
    "k3": (("ta", "trans_a_launches"), ("wgmma", "wgmma_launches")),
    "k4": (("wgmma", "wgmma_launches"), ("split", "split_launches"),
           ("tf32x3", "tf32x3_launches")),
    "k5": (("wgmma", "wgmma_launches"), ("split", "split_launches")),
    "k6": (("stream", "stream_launches"),),
    "k7": (("stream", "stream_launches"),),
}
_EXTRA.update(k1g=_EXTRA["k1"], k2g=_EXTRA["k2"], k3g=_EXTRA["k3"])


def _table() -> Dict[str, Tuple[object, str]]:
    table = {}
    for key, fn in wrappers().items():
        table[key] = (fn, "launches")
        for suffix, attr in _EXTRA.get(key, ()):
            table[f"{key}_{suffix}"] = (fn, attr)
    return table


def launch_counts() -> Dict[str, int]:
    """Every launch count, by the names of the module docstring."""
    return {name: getattr(fn, attr) for name, (fn, attr) in _table().items()}


def reset_launch_counts() -> None:
    """Every launch count to 0."""
    for fn, attr in _table().values():
        setattr(fn, attr, 0)


def count_delta(after: Dict[str, int],
                before: Dict[str, int]) -> Dict[str, int]:
    """``after - before`` by name, the counts that did not move left
    out."""
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def add_launch_counts(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counts it names (``times=-1``
    rolls a delta back)."""
    table = _table()
    for name, n in delta.items():
        fn, attr = table[name]
        setattr(fn, attr, getattr(fn, attr) + times * n)
