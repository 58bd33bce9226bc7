"""Federated fine-tuning of a ~100M-param language model with HiCS-FL
client selection: the port of the reference's
``examples/federated_finetune.py``.

The selector reads only the LM head's update, here the bias-free ΔW
row-mean surrogate (``repro_torch.core.head_bias_update``), never the
body.  The ~100M model is qwen3-8b reduced to 4 layers at d_model 768
with a 32k vocabulary; ``--tiny`` is the config's own ``reduced()``.
Clients hold synthetic token streams with Dirichlet-skewed topic
mixtures, the LM analogue of label heterogeneity.

  PYTHONPATH=src python -m repro_torch.examples.federated_finetune       # card
  PYTHONPATH=src python -m repro_torch.examples.federated_finetune \\
      --tiny --device cpu

Each round the selected clients train one epoch of sgd (lr 0.2, one
sequence a step, gradients clipped to global norm 1) from the global
params, the server averages them, and the selector observes each
client's head Δb.  Weights come from a generator on the device seeded
0, token streams from ``np.random.default_rng(0)``, the selector's
noise from its own CPU generator seeded 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device, set_precision
from repro_torch.configs import get_config
from repro_torch.core import head_bias_update, head_num_classes, make_selector
from repro_torch.data import make_lm_streams
from repro_torch.launch.train import local_lm_update
from repro_torch.models import get_model
from repro_torch.optim import tree_leaves, tree_map

LR = 0.2


def model_config(tiny: bool):
    """The example's config: qwen3-8b's ``reduced()``, or its ~100M cut."""
    base = get_config("qwen3-8b")
    if tiny:
        return base.reduced()
    return dataclasses.replace(
        base.reduced(), name="qwen3-100m", num_layers=4, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
        vocab_size=32_768)


def main(argv=None) -> dict:
    """Run the example; returns {"history", "cfg", "params", "selector",
    "n_params"}.  The history has, per round, the mean local loss, the
    participants, the spread of Ĥ over the clients (max − min, 0 before
    any observation) and the round's wall seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()

    cfg = model_config(args.tiny)
    if args.tiny:
        rounds = args.rounds or 6
        clients, select, seq, seqs = 8, 2, 64, 2
    else:
        rounds = args.rounds or 200
        clients, select, seq, seqs = 16, 4, 256, 2

    api = get_model(cfg)
    params = api.init(0, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}  {n_params/1e6:.1f}M params  "
          f"vocab={cfg.vocab_size}")

    rng = np.random.default_rng(0)
    toks, _ = make_lm_streams(rng, cfg.vocab_size, seq + 1, clients, seqs,
                              alphas=(0.05,) * 3 + (5.0,))
    toks = torch.as_tensor(toks, device=device)

    sel = make_selector("hics", num_clients=clients, num_select=select,
                        total_rounds=rounds, temperature=0.63,
                        normalize=True, gamma0=4.0, seed=0,
                        num_classes=head_num_classes(params) or 1,
                        device=device)
    history = {"round": [], "loss": [], "selected": [], "spread": [],
               "wall_s": []}
    t_start = time.time()
    for t in range(rounds):
        t0 = time.perf_counter()
        ids = sel.select(t)
        locals_, dbs, losses = [], [], []
        for k in ids:
            pk, loss = local_lm_update(api, params, toks[k], LR, 1)
            locals_.append(pk)
            dbs.append(head_bias_update(params, pk))
            losses.append(float(loss))
        with torch.no_grad():
            params = tree_map(lambda *xs: torch.stack(xs).mean(dim=0),
                              *locals_)
        del locals_
        sel.update(t, ids, bias_updates=torch.stack(dbs))
        ent = sel.estimated_entropies()
        spread = float(np.ptp(ent)) if ent is not None else 0.0
        history["round"].append(t)
        history["loss"].append(float(np.mean(losses)))
        history["selected"].append(list(map(int, ids)))
        history["spread"].append(spread)
        history["wall_s"].append(time.perf_counter() - t0)
        if t % max(1, rounds // 20) == 0 or t == rounds - 1:
            print(f"round {t:4d} loss={np.mean(losses):.4f} "
                  f"sel={sorted(map(int, ids))} Ĥ-spread={spread:.3f} "
                  f"({time.time()-t_start:.0f}s)", flush=True)
    print(f"\ndone: {rounds} rounds in {time.time()-t_start:.0f}s; "
          f"selector overhead {sel.select_seconds + sel.update_seconds:.2f}s"
          f" total (model has {n_params/1e6:.1f}M params the selector "
          "never touches)")
    return {"history": history, "cfg": cfg, "params": params,
            "selector": sel, "n_params": n_params}


if __name__ == "__main__":
    main()
