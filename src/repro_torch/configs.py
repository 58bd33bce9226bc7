"""The paper's client models (App. A.1.1): widths of paper-cnn and
paper-mlp, copied from the reference's ``configs/paper_cnn.py``.

``d_model`` doubles as the hidden width (the CNN's second conv's
channel count), ``d_ff`` is the fc width and ``vocab_size`` the number
of classes C.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    name: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    source: str


CONFIGS = {
    "paper-cnn": ClassifierConfig(
        name="paper-cnn", num_layers=2, d_model=64, d_ff=128,
        vocab_size=10, source="HiCS-FL App. A.1.1 (FMNIST CNN)"),
    "paper-mlp": ClassifierConfig(
        name="paper-mlp", num_layers=2, d_model=128, d_ff=128,
        vocab_size=10, source="HiCS-FL App. A.1.1 (MLP variant)"),
}


def get_config(name: str) -> ClassifierConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]
