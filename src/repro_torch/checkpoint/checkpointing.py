"""Checkpointing: one ``.npy`` per leaf plus a JSON manifest (port of
``repro.checkpoint.checkpointing`` on one host).

A save copies every leaf to host numpy first, then writes -- on a
background thread unless ``blocking`` -- into a temp directory that is
renamed into place, so a crash mid-save never corrupts the latest
checkpoint; the ``keep`` newest are kept.  Copying before the thread
starts matters: the optimizer updates parameters and moments in place.
bf16 leaves are stored as their uint16 bits with the dtype in the
manifest.  A tree is nested dicts, lists and tuples (``AdamWState``'s
fields by name) of tensors; a leaf's key is its path joined by ``/``.
The reference's sharded restore (``target_shardings``) belongs to the
sharded path and is not ported.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

def _flatten(tree, prefix=""):
    """{path: leaf} in a fixed order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):                 # NamedTuple
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(tree_like, leaves, prefix=""):
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree_like.items()}
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*(
            _unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in zip(tree_like._fields, tree_like)))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree_like))
    return leaves[prefix]


def _to_host(t: torch.Tensor):
    """(a numpy copy, logical dtype name) -- bf16 as its uint16 bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # copy=True: a CPU tensor's numpy view would share its memory.
        bits = t.view(torch.int16).to("cpu", copy=True).numpy()
        return bits.view(np.uint16), "bfloat16"
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=like.device, dtype=like.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = True):
        """Snapshot ``tree`` at ``step``; the host copy is made before this
        returns, the write may run on a background thread."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self.wait()

        def _write():
            tmp = os.path.join(self.directory, f".tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": {}}
            for key, (arr, dtype) in host.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {"file": fname,
                                           "shape": list(arr.shape),
                                           "dtype": dtype}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.list_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def list_steps(self):
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None):
        """-> (tree in ``tree_like``'s structure, each leaf on its
        counterpart's device and dtype, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, like in _flatten(tree_like).items():
            info = manifest["leaves"][key]
            arr = np.load(os.path.join(d, info["file"]))
            leaves[key] = _from_host(arr, info["dtype"], like)
        return _unflatten(tree_like, leaves), manifest
