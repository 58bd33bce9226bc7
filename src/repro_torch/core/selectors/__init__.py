"""Client selectors of the port: the functional protocol, HiCS-FL, the
paper's five baselines, and the OO shims over them."""
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
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   Observations,
                                                   SelectNoise,
                                                   SelectorState,
                                                   draw_select_noise,
                                                   init_state, mark_seen,
                                                   stale_append,
                                                   stale_clear,
                                                   state_entropies)
from repro_torch.core.selectors.hics import HiCSFLSelector, hics_functional
from repro_torch.core.selectors.registry import (FUNCTIONAL, SELECTORS,
                                                 make_functional,
                                                 make_selector)

__all__ = ["ClientSelector", "ClusteredSamplingSelector", "DivFLSelector",
           "FUNCTIONAL", "FedCorSelector", "FunctionalSelector",
           "HiCSFLSelector", "Observations", "PowerOfChoiceSelector",
           "RandomSelector", "SELECTORS", "SelectNoise", "SelectorState",
           "cs_functional", "divfl_functional", "draw_select_noise",
           "fedcor_functional", "hics_functional", "init_state",
           "make_functional", "make_selector", "mark_seen",
           "powd_functional", "random_functional", "stale_append",
           "stale_clear", "state_entropies"]
