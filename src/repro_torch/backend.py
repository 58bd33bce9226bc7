"""Device resolution and numeric precision for the PyTorch port.

Every entry point of the port takes an explicit ``device`` and defaults
to ``"cuda"``.  There is no silent CPU: asking for the card on a
machine without one raises, and only an explicit ``device="cpu"``
runs the plain PyTorch versions (the tests pass it).

The JAX reference computes in full f32.  PyTorch's f32 matmul is full
f32 by default, but cuDNN convolutions default to TF32, which keeps
about three decimal digits, and paper-cnn is a CNN.
:func:`set_precision` turns TF32 off for both.  It also restricts cuDNN
to deterministic algorithms: with the default ones, two card runs of
the same spec trained the same cohort to different losses (atomic sums
in another order each run), and paper-cnn's local training grows such
last-bit differences to ~1e-3 in two rounds, so a run could not be
repeated.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device
    on a machine without one, and for any type but cpu, cuda and meta
    (shapes and dtypes with no storage, for the dry run)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev


def set_precision() -> None:
    """Full f32 everywhere, TF32 off for matmul and for cuDNN, and
    deterministic cuDNN algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.set_float32_matmul_precision("highest")
