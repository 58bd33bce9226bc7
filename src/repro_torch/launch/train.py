"""Federated LM fine-tuning driver, the port of the reference's
``launch/train.py``:

  * an assigned architecture (``--arch``, reduced or full),
  * synthetic per-client token streams with Dirichlet topic skew,
  * per-round client selection (HiCS-FL or any baseline) through the
    OO shim, from the LM head's Δb,
  * local training of each selected client on one device,
  * npz checkpointing.

Each round the server broadcasts θ^t, the selected clients run R local
epochs on their own token stream (one sequence a step, gradients
clipped to global norm 1), the server averages the returned models and
feeds the head's Δb to the selector: Algorithm 1 with the classifier
replaced by a language model, where C is the vocabulary.

Memory is the constraint at full width: qwen2.5-3b's f32 params are
13.6 GB a copy.  The round keeps four trees: the global params, the
client's copy, the running sum of the cohort's models and the
gradients.  Clipping and the sgd step are applied in place, leaf by
leaf; of each client only the head's bias is kept, for Δb.  qwen3-8b
(the default arch) needs ~98 GB for three of those trees, so the card
trains qwen2.5-3b at full width (``--arch qwen2.5-3b --full``).

Usage (flags as the reference's, plus --device):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --rounds 6 --clients 8 --select 2 --seq-len 32 --seqs-per-client 2
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2.5-3b --full --rounds 6      # the card

The default device is ``cuda``: without a card it raises.  Weights come
from a generator on the device seeded by --seed, token streams from
numpy's ``default_rng(seed)``, the selector's noise from a CPU
generator seeded by --seed.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device, set_precision
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core import (head_bias_updates_stacked, head_num_classes,
                              make_selector)
from repro_torch.core.selectors.functional import TELEMETRY, not_ported
from repro_torch.data import make_lm_streams
from repro_torch.models import get_model
from repro_torch.optim import (adam, clip_by_global_norm_, tree_leaves,
                               tree_map)


@torch.no_grad()
def _copy_tree(src: dict, out: Optional[dict]) -> dict:
    if out is None:
        return tree_map(torch.clone, src)
    tree_map(lambda o, s: o.copy_(s), out, src)
    return out


def local_lm_update(api, params, tokens, lr, epochs, opt_name="sgd", *,
                    out: Optional[dict] = None):
    """R epochs of LM training on one client's (num_seqs, S + 1) stream,
    from ``params``, which stay as they are.  The client trains a copy:
    ``out`` (a tree of the params' shapes, overwritten) or a new one.
    Each step takes one sequence (tokens ``seq[:-1]``, targets
    ``seq[1:]``), clips the gradients to global norm 1 and applies the
    optimizer, in place.  Returns (the trained params, the mean over
    epochs of the mean loss over steps, a 0-d tensor)."""
    local = _copy_tree(params, out)
    leaves = tuple(tree_leaves(local))
    opt = adam(lr) if opt_name == "adam" else None
    opt_state = opt.init(leaves) if opt is not None else None
    s = tokens.shape[-1] - 1
    mask = torch.ones((1, s), device=tokens.device)
    epoch_losses = []
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        for _ in range(epochs):
            step_losses = []
            for seq in tokens:
                batch = {"tokens": seq[None, :-1], "targets": seq[None, 1:],
                         "loss_mask": mask}
                loss, _ = api.loss(local, batch)
                grads = torch.autograd.grad(loss, leaves)
                clip_by_global_norm_(grads, 1.0)
                with torch.no_grad():
                    if opt is None:     # sgd: p += (−lr)·g
                        for p, g in zip(leaves, grads):
                            p.add_(g, alpha=-lr)
                    else:
                        updates, opt_state = opt.update(grads, opt_state,
                                                        leaves)
                        for p, u in zip(leaves, updates):
                            p.add_(u)
                        del updates
                del grads             # before the next step's backward
                step_losses.append(loss.detach())
            epoch_losses.append(torch.stack(step_losses).mean())
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    return local, torch.stack(epoch_losses).mean()


def _head(tree: dict) -> dict:
    """The head leaf Δb is read from: the bias, else the weight (the
    bias-free surrogate), as ``head_bias_updates_stacked`` reads it."""
    head = tree.get("lm_head", {})
    for k in ("b", "w"):
        if k in head:
            return {k: head[k]}
    return {}


def train_rounds(api, params: dict, tokens: torch.Tensor, selector, *,
                 rounds: int, lr: float, epochs: int,
                 noise: Optional[Callable] = None, ckpt_dir: str = "",
                 record: Optional[list] = None):
    """``rounds`` rounds of federated fine-tuning from ``params`` with
    ``selector`` (an OO shim).  The given params' buffers are reused
    (one more tree at full width would not fit): pass a copy to keep
    them.  ``noise(t)`` gives round t's :class:`SelectNoise` (default:
    the shim's own draws).  Returns (the final params, the history).
    ``record``, if given, gets one dict a round: the ids, Δb on the CPU
    and the seconds of the select and of the cohort's local updates
    (ending in a device synchronize)."""
    history = {"round": [], "loss": [], "selected": [],
               "bias_entropy": [], "wall_s": []}
    local = tree_map(torch.empty_like, params)
    acc = tree_map(torch.empty_like, params)
    for t in range(rounds):
        t0 = time.perf_counter()
        ids = selector.select(t, None if noise is None else noise(t))
        t1 = time.perf_counter()
        heads, losses = [], []
        for i, k in enumerate(ids):
            # the first client trains in the cohort's running sum
            pk, loss = local_lm_update(api, params, tokens[k], lr, epochs,
                                       out=acc if i == 0 else local)
            if i:
                with torch.no_grad():
                    tree_map(lambda a, p: a.add_(p), acc, pk)
            heads.append({k_: v.clone() for k_, v in _head(pk).items()})
            losses.append(loss)
        losses = torch.stack(losses).tolist()
        local_s = time.perf_counter() - t1
        dbs = (head_bias_updates_stacked(params, {"lm_head": {
            k_: torch.stack([h[k_] for h in heads]) for k_ in heads[0]}})
            if heads[0] else None)
        # θ^{t+1} = (1/K) Σ θ_k; the old params' buffers hold the next
        # round's sum
        with torch.no_grad():
            tree_map(lambda a: a.div_(len(ids)), acc)
        params, acc = acc, params
        selector.update(t, ids, bias_updates=dbs)
        ent = selector.estimated_entropies()
        history["round"].append(t)
        history["loss"].append(float(np.mean(losses)))
        history["selected"].append(list(map(int, ids)))
        history["bias_entropy"].append(None if ent is None else ent.tolist())
        history["wall_s"].append(time.perf_counter() - t0)
        if record is not None:
            record.append({"ids": list(ids), "local_s": local_s,
                           "select_s": t1 - t0,
                           "delta_b": None if dbs is None else dbs.cpu()})
        print(f"round {t:3d} loss={np.mean(losses):.4f} "
              f"sel={list(ids)} "
              f"({history['wall_s'][-1]:.1f}s)", flush=True)
        if ckpt_dir and (t + 1) % 10 == 0:
            save_pytree(Path(ckpt_dir) / f"step_{t+1}.npz", params,
                        step=t + 1)
    return params, history


def main(argv=None) -> dict:
    """The reference's CLI.  Returns {"history", "params" (final),
    "cfg", "tokens", "selector", "record", "init_s"}; the history
    (also written to --out) has the reference's keys."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--select", type=int, default=2)
    ap.add_argument("--selector", default="hics")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--seqs-per-client", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--temperature", type=float, default=0.01)
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.05, 0.05, 0.05, 5.0])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--telemetry", default="",
                    help="per-round telemetry (not ported: raises)")
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.telemetry:
        raise not_ported("telemetry", args.telemetry, TELEMETRY)

    device = resolve_device(args.device)
    set_precision()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    rng = np.random.default_rng(args.seed)
    toks, _ = make_lm_streams(
        rng, cfg.vocab_size, args.seq_len + 1, args.clients,
        args.seqs_per_client, args.alphas)
    toks = torch.as_tensor(toks, device=device)

    t0 = time.perf_counter()
    params = api.init(args.seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M vocab={cfg.vocab_size}")

    # uniform kwarg surface: selectors ignore the kwargs they don't use
    sel = make_selector(args.selector, num_clients=args.clients,
                        num_select=args.select, total_rounds=args.rounds,
                        temperature=args.temperature,
                        num_classes=head_num_classes(params) or 1,
                        seed=args.seed, device=device)
    record: list = []
    params, history = train_rounds(api, params, toks, sel,
                                   rounds=args.rounds, lr=args.lr,
                                   epochs=args.epochs,
                                   ckpt_dir=args.ckpt_dir, record=record)
    history["select_seconds"] = sel.select_seconds
    history["update_seconds"] = sel.update_seconds
    if args.out:
        Path(args.out).write_text(json.dumps(history, indent=1))
    print("done. final loss:", history["loss"][-1])
    return {"history": history, "params": params, "cfg": cfg, "tokens": toks,
            "selector": sel, "record": record, "init_s": init_s}


if __name__ == "__main__":
    main()
