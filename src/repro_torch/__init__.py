"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (sm_90a).

Module paths mirror ``src/repro/``: the reference for ``repro_torch/X.py``
is always ``repro/X.py``.  The port imports ``torch``, numpy and the
standard library only -- never ``jax`` and nothing of ``repro``.

Dispatch is by the tensor's device: every kernel wrapper runs its plain
PyTorch version for a CPU tensor and launches its hand-written CUDA kernel
for a CUDA tensor (or raises for a variant the kernel does not take).
Entry points default to ``device="cuda"`` and run on the CPU only when the
caller asks for it.
"""
