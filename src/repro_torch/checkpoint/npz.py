"""npz pytree checkpointing with step metadata: the port of the
reference's ``checkpoint/npz.py``, in its file format.

A leaf's flat key is its '/'-joined path, dict keys sorted at every
level (the reference's ``tree_flatten_with_path`` order), list and
tuple items by index.  dtype and shape round-trip exactly; bfloat16 is
stored as its uint16 bits under the key plus ``__bf16__``, since npz
has no bfloat16.  A file written by either package loads in the other.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_BF16 = "__bf16__"


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_flatten(sub, f"{prefix}/{key}" if prefix else key))
    return out


def save_pytree(path, tree, step: Optional[int] = None) -> Path:
    """Write ``tree`` (nested dicts, lists or tuples of tensors or
    arrays) to ``path`` (npz).  Returns the written path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    meta = {"step": step, "keys": []}
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                arrays[key + _BF16] = leaf.view(torch.int16).numpy().view(
                    np.uint16)
                meta["keys"].append(key)
                continue
            leaf = leaf.numpy()
        arrays[key] = np.asarray(leaf)
        meta["keys"].append(key)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def load_pytree(path) -> Tuple[Dict[str, torch.Tensor], Optional[int]]:
    """Read a checkpoint into {flat_key: CPU tensor} and its step; a
    ``__bf16__`` leaf comes back as a bfloat16 tensor."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        out = {}
        for k in z.files:
            if k == "__meta__":
                continue
            if k.endswith(_BF16):
                bits = torch.from_numpy(z[k].view(np.int16).copy())
                out[k[: -len(_BF16)]] = bits.view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(z[k].copy())
    return out, meta.get("step")


def restore(path, like):
    """Load into the structure of ``like`` (a tree of tensors): each
    leaf in the template's dtype and on its device.  Returns (tree,
    step)."""
    flat, step = load_pytree(path)
    template = _flatten(like)
    missing = set(template) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    for key, leaf in template.items():
        if tuple(flat[key].shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(flat[key].shape)} != "
                             f"{tuple(leaf.shape)}")

    def build(node, prefix=""):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [build(v, f"{prefix}/{i}" if prefix else str(i))
                   for i, v in enumerate(node)]
            return type(node)(out)
        return flat[prefix].to(dtype=node.dtype, device=node.device)

    return build(like), step


def latest_step(ckpt_dir) -> Optional[Path]:
    """Newest ``step_<n>.npz`` under ``ckpt_dir``."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return None
    best, best_n = None, -1
    for p in ckpt_dir.glob("step_*.npz"):
        m = re.match(r"step_(\d+)", p.stem)
        if m and int(m.group(1)) > best_n:
            best, best_n = p, int(m.group(1))
    return best
