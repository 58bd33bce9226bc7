"""Client selectors of the port: the functional protocol, HiCS-FL and
the paper's five baselines."""
from repro_torch.core.selectors.baselines import (cs_functional,
                                                  divfl_functional,
                                                  fedcor_functional,
                                                  powd_functional,
                                                  random_functional)
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   Observations,
                                                   SelectNoise,
                                                   SelectorState,
                                                   init_state, mark_seen,
                                                   stale_append,
                                                   stale_clear)
from repro_torch.core.selectors.hics import hics_functional
from repro_torch.core.selectors.registry import FUNCTIONAL, make_functional

__all__ = ["FUNCTIONAL", "FunctionalSelector", "Observations",
           "SelectNoise", "SelectorState", "cs_functional",
           "divfl_functional", "fedcor_functional", "hics_functional",
           "init_state", "make_functional", "mark_seen", "powd_functional",
           "random_functional", "stale_append", "stale_clear"]
