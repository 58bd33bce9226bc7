"""HiCS-FL in PyTorch and CUDA: the port of ``repro`` to one NVIDIA H100.

The package mirrors ``src/repro/`` module by module.  It imports torch,
numpy and the standard library, never JAX and nothing of ``repro``.
Entry points take an explicit ``device`` and default to ``"cuda"``;
only ``device="cpu"`` runs on the CPU, through the plain PyTorch
versions of the kernels.
"""
