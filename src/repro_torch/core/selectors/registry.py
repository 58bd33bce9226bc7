"""The selectors by name: OO shims and functional factories.

    sel = make_selector("hics", num_clients=N, num_select=K,
                        total_rounds=T, temperature=T_soft, device="cuda")
    ids = sel.select(t)                      # or sel.select(t, noise)
    sel.update(t, ids, bias_updates=...)

    fn = make_functional("cs", num_clients=N, num_select=K,
                         total_rounds=T, weights=p, feat_dim=P,
                         device="cuda")
    state = fn.init()
    ids, state = fn.select(state, t, noise)
    state = fn.update(state, t, ids, Observations(full_updates=...))

Both registries take one uniform kwarg surface: hyper-parameters a
selector does not use are ignored, so a caller can pass one kwargs
dict for any name.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.selectors.base import ClientSelector
from repro_torch.core.selectors.baselines import (ClusteredSamplingSelector,
                                                  DivFLSelector,
                                                  FedCorSelector,
                                                  PowerOfChoiceSelector,
                                                  RandomSelector,
                                                  cs_functional,
                                                  divfl_functional,
                                                  fedcor_functional,
                                                  powd_functional,
                                                  random_functional)
from repro_torch.core.selectors.functional import FunctionalSelector
from repro_torch.core.selectors.hics import HiCSFLSelector, hics_functional

SELECTORS: Dict[str, type] = {
    "random": RandomSelector,
    "pow-d": PowerOfChoiceSelector,
    "cs": ClusteredSamplingSelector,
    "divfl": DivFLSelector,
    "fedcor": FedCorSelector,
    "hics": HiCSFLSelector,
}

FUNCTIONAL: Dict[str, Callable[..., FunctionalSelector]] = {
    "random": random_functional,
    "pow-d": powd_functional,
    "cs": cs_functional,
    "divfl": divfl_functional,
    "fedcor": fedcor_functional,
    "hics": hics_functional,
}


def make_selector(name: str, **kw) -> ClientSelector:
    """Build an OO shim selector by name (its state on ``device``,
    default the card)."""
    try:
        cls = SELECTORS[name]
    except KeyError:
        raise KeyError(f"unknown selector {name!r}; known: "
                       f"{sorted(SELECTORS)}") from None
    return cls(**kw)


def make_functional(name: str, device="cuda", **kw) -> FunctionalSelector:
    """Build a functional (init, select, update) triple by name, its
    state on ``device``."""
    try:
        factory = FUNCTIONAL[name]
    except KeyError:
        raise KeyError(f"unknown selector {name!r}; known: "
                       f"{sorted(FUNCTIONAL)}") from None
    return factory(device=device, **kw)
