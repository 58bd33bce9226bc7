"""Synthetic datasets (numpy): a copy of the reference's
``data/synthetic.py``.

Classification: class c has a random prototype μ_c ∈ R^d and a
low-rank within-class subspace, and samples are μ_c + Us + noise.
LM streams: per-client token streams whose topic mixture is
Dirichlet-skewed, the LM analogue of a label distribution.  The same
``rng`` gives the same arrays as the reference, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    num_classes: int = 10
    dim: int = 196               # 14x14 "image" for the paper CNN
    rank: int = 8                # within-class subspace rank
    noise: float = 0.30          # isotropic noise std
    proto_scale: float = 1.5


def make_classification_data(rng: np.random.Generator, spec: SyntheticSpec,
                             num_samples: int
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x (S, dim) f32, y (S,) i32, prototypes (C, dim))."""
    C, d = spec.num_classes, spec.dim
    protos = rng.normal(size=(C, d))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    protos *= spec.proto_scale
    bases = rng.normal(size=(C, d, spec.rank)) / np.sqrt(d)
    y = rng.integers(0, C, size=num_samples)
    coef = rng.normal(size=(num_samples, spec.rank))
    x = protos[y] + np.einsum("sdr,sr->sd", bases[y], coef) \
        + spec.noise * rng.normal(size=(num_samples, d))
    return x.astype(np.float32), y.astype(np.int32), protos.astype(np.float32)


def make_train_test(rng: np.random.Generator, spec: SyntheticSpec,
                    samples_train: int, samples_test: int
                    ) -> Tuple[Dict[str, np.ndarray],
                               Dict[str, np.ndarray], np.ndarray]:
    """``train = {x, y}``, ``test = {x, y, mask}`` (test mask all ones)
    and the class prototypes, drawn as one task from ``rng``."""
    x, y, protos = make_classification_data(
        rng, spec, samples_train + samples_test)
    train = {"x": x[:samples_train], "y": y[:samples_train]}
    test = {"x": x[samples_train:], "y": y[samples_train:],
            "mask": np.ones(samples_test, dtype=np.float32)}
    return train, test, protos


def make_lm_streams(rng: np.random.Generator, vocab: int, seq_len: int,
                    num_clients: int, seqs_per_client: int,
                    alphas: Sequence[float],
                    num_topics: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Per-client token streams with Dirichlet-skewed topic mixtures.

    Returns (tokens (N, seqs, seq_len) i32, topic_mix (N, num_topics)).
    Each topic is a unigram distribution over the vocab; a client's
    next-token distribution is its topic mixture.  The clients are
    split into ``len(alphas)`` groups, group g drawing its mixtures with
    concentration ``alphas[g]``.
    """
    groups = np.array_split(np.arange(num_clients), len(alphas))
    topic_logits = rng.normal(size=(num_topics, vocab)) * 2.0
    topic_p = _softmax(topic_logits, axis=-1)
    mixes = np.zeros((num_clients, num_topics))
    for g, alpha in zip(groups, alphas):
        for k in g:
            mixes[k] = rng.dirichlet(np.full(num_topics, alpha))
    toks = np.zeros((num_clients, seqs_per_client, seq_len), dtype=np.int32)
    for k in range(num_clients):
        p = mixes[k] @ topic_p
        toks[k] = rng.choice(vocab, size=(seqs_per_client, seq_len), p=p)
    return toks, mixes


def client_label_distributions(client_labels: Sequence[np.ndarray],
                               num_classes: int) -> np.ndarray:
    """Empirical per-client label distribution matrix (N, C)."""
    out = np.zeros((len(client_labels), num_classes))
    for i, y in enumerate(client_labels):
        if len(y):
            cnt = np.bincount(y, minlength=num_classes)
            out[i] = cnt / cnt.sum()
    return out


def pad_and_stack(xs: List[np.ndarray], ys: List[np.ndarray]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack ragged per-client datasets into (N, Smax, d) + mask.
    Padded rows carry label 0 and mask 0."""
    n = len(xs)
    smax = max(1, max(len(x) for x in xs))
    d = xs[0].shape[1]
    X = np.zeros((n, smax, d), dtype=np.float32)
    Y = np.zeros((n, smax), dtype=np.int32)
    M = np.zeros((n, smax), dtype=np.float32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        s = len(x)
        X[i, :s], Y[i, :s], M[i, :s] = x, y, 1.0
    return X, Y, M


def _softmax(x, axis=-1):
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=axis, keepdims=True)
