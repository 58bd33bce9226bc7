"""One-call federated experiment builder.

The port of the reference's ``fed/simulation.py``: a multi-α Dirichlet
cohort over the synthetic Gaussian-mixture task, paper-cnn or
paper-mlp, any of the six selectors, any local update (Moon gets the
model's penultimate features) and the server's round loop.  The data
and the partition come from ``np.random.default_rng(spec.seed)`` by
the reference's own code path, so both packages see identical arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.backend import resolve_device, set_precision
from repro_torch.configs import get_config
from repro_torch.data import (SyntheticSpec, client_label_distributions,
                              make_train_test, pad_and_stack)
from repro_torch.fed.client import LocalSpec
from repro_torch.fed.partition import multi_alpha_partition
from repro_torch.fed.server import FedConfig, FederatedServer
from repro_torch.models.classifier import (make_classifier,
                                           make_classifier_with_features)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    arch: str = "paper-cnn"            # paper-cnn | paper-mlp
    num_clients: int = 50
    num_select: int = 5
    rounds: int = 100
    alphas: Sequence[float] = (0.001, 0.002, 0.005, 0.01, 0.5)
    selector: str = "hics"
    selector_kw: Optional[Dict[str, Any]] = None
    local: LocalSpec = dataclasses.field(default_factory=LocalSpec)
    samples_train: int = 10_000
    samples_test: int = 2_000
    data: SyntheticSpec = dataclasses.field(default_factory=SyntheticSpec)
    eval_every: int = 5
    seed: int = 0
    jit_rounds: bool = False       # the segmented driver: see fed.server
    telemetry: Sequence[str] = ()  # refused: see fed.server.FedConfig


def build(spec: ExperimentSpec, device="cuda"):
    """Returns (server, info) ready to ``.run()`` on ``device``.

    Raises when ``device`` is CUDA and there is no card.  Calls
    :func:`repro_torch.backend.set_precision` first, which turns TF32
    off for matmul and cuDNN, so the run computes in full f32 as the
    reference does.
    """
    dev = resolve_device(device)
    set_precision()
    fed_cfg = FedConfig(
        num_clients=spec.num_clients, num_select=spec.num_select,
        rounds=spec.rounds, selector=spec.selector,
        selector_kw=spec.selector_kw, local=spec.local,
        eval_every=spec.eval_every, seed=spec.seed,
        jit_rounds=spec.jit_rounds, telemetry=tuple(spec.telemetry))
    rng = np.random.default_rng(spec.seed)
    cfg = get_config(spec.arch)
    data_spec = dataclasses.replace(spec.data, num_classes=cfg.vocab_size)
    train, test, protos = make_train_test(
        rng, data_spec, spec.samples_train, spec.samples_test)
    xtr, ytr = train["x"], train["y"]
    parts, client_alpha = multi_alpha_partition(
        rng, ytr, spec.num_clients, spec.alphas)
    xs = [xtr[p] for p in parts]
    ys = [ytr[p] for p in parts]
    X, Y, M = pad_and_stack(xs, ys)
    label_dists = client_label_distributions(ys, data_spec.num_classes)
    if spec.local.algo == "moon":
        init, apply, features = make_classifier_with_features(
            cfg, input_dim=data_spec.dim)
    else:
        init, apply, _ = make_classifier(cfg, input_dim=data_spec.dim)
        features = None
    server = FederatedServer(init, apply, fed_cfg, X, Y, M, test=test,
                             device=dev, features_fn=features)
    info = {"label_dists": label_dists, "client_alpha": client_alpha,
            "client_sizes": M.sum(axis=1), "prototypes": protos}
    return server, info


def run_experiment(spec: ExperimentSpec, progress: bool = False,
                   device="cuda") -> Dict[str, Any]:
    """Build and run one experiment; the history with the partition's
    label distributions and client alphas."""
    server, info = build(spec, device=device)
    hist = server.run(progress=progress)
    hist["label_dists"] = info["label_dists"].tolist()
    hist["client_alpha"] = info["client_alpha"].tolist()
    return hist


# The paper's concentration-parameter settings (§4.1), FMNIST block.
PAPER_SETTINGS = {
    "setting1": (0.001, 0.002, 0.005, 0.01, 0.5),   # 80% severe + 20% bal
    "setting2": (0.001, 0.002, 0.005, 0.01, 0.2),   # 80% severe + 20% mild
    "setting3": (0.001,),                            # all severe
}
