"""HiCS-FL core of the port: estimator, clustering, sampling,
selectors."""
from repro_torch.core.clustering import (agglomerate_device,
                                         cluster_means_device)
from repro_torch.core.hetero import (estimate_entropy,
                                     head_bias_updates_stacked,
                                     head_num_classes, label_entropy,
                                     softmax_entropy)
from repro_torch.core.sampling import (anneal_device, coverage_sweep_device,
                                       gumbel_topk,
                                       hierarchical_sample_device,
                                       weighted_sample_device)
from repro_torch.core.selectors import (FUNCTIONAL, SELECTORS,
                                        ClientSelector, Observations,
                                        SelectNoise, SelectorState,
                                        hics_functional, make_functional,
                                        make_selector)

__all__ = ["ClientSelector", "FUNCTIONAL", "Observations", "SELECTORS",
           "SelectNoise", "SelectorState",
           "agglomerate_device", "anneal_device", "cluster_means_device",
           "coverage_sweep_device", "estimate_entropy", "gumbel_topk",
           "head_bias_updates_stacked", "head_num_classes",
           "hics_functional", "hierarchical_sample_device",
           "label_entropy", "make_functional", "make_selector",
           "softmax_entropy",
           "weighted_sample_device"]
