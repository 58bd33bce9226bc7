"""The functional selectors by name.

    fn = make_functional("cs", num_clients=N, num_select=K,
                         total_rounds=T, weights=p, feat_dim=P,
                         device="cuda")
    state = fn.init()
    ids, state = fn.select(state, t, noise)
    state = fn.update(state, t, ids, Observations(full_updates=...))

Every factory takes one uniform kwarg surface: hyper-parameters a
selector does not use are ignored, so a caller can pass one kwargs
dict for any name.  The reference's OO shims are not ported.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.core.selectors.baselines import (cs_functional,
                                                  divfl_functional,
                                                  fedcor_functional,
                                                  powd_functional,
                                                  random_functional)
from repro_torch.core.selectors.functional import FunctionalSelector
from repro_torch.core.selectors.hics import hics_functional

FUNCTIONAL: Dict[str, Callable[..., FunctionalSelector]] = {
    "random": random_functional,
    "pow-d": powd_functional,
    "cs": cs_functional,
    "divfl": divfl_functional,
    "fedcor": fedcor_functional,
    "hics": hics_functional,
}


def make_functional(name: str, device="cuda", **kw) -> FunctionalSelector:
    """Build a functional (init, select, update) triple by name, its
    state on ``device``."""
    try:
        factory = FUNCTIONAL[name]
    except KeyError:
        raise KeyError(f"unknown selector {name!r}; known: "
                       f"{sorted(FUNCTIONAL)}") from None
    return factory(device=device, **kw)
