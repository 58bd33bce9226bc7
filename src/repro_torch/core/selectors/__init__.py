"""Client selectors of the port: the functional protocol and HiCS-FL."""
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   SelectNoise,
                                                   SelectorState,
                                                   init_state, mark_seen,
                                                   stale_append,
                                                   stale_clear)
from repro_torch.core.selectors.hics import hics_functional

__all__ = ["FunctionalSelector", "SelectNoise", "SelectorState",
           "hics_functional", "init_state", "mark_seen", "stale_append",
           "stale_clear"]
