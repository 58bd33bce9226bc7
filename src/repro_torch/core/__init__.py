"""HiCS-FL core of the port: estimator and its theory helpers, the Eq. 9
distance, clustering, sampling, selectors."""
from repro_torch.core.clustering import (agglomerate, agglomerate_device,
                                         cluster_means, cluster_means_device,
                                         silhouette_hint)
from repro_torch.core.distance import distance_matrix, pairwise_arccos
from repro_torch.core.hetero import (delta_b_from_head_delta,
                                     dissimilarity_envelope,
                                     entropy_separation_bound,
                                     estimate_entropy, expected_bias_update,
                                     head_bias_update,
                                     head_bias_updates_stacked,
                                     head_num_classes, label_entropy,
                                     softmax_entropy)
from repro_torch.core.sampling import (anneal, anneal_device, cluster_probs,
                                       coverage_sweep_device, gumbel_topk,
                                       hierarchical_sample,
                                       hierarchical_sample_device,
                                       sampling_probabilities,
                                       weighted_sample_device)
from repro_torch.core.selectors import (FUNCTIONAL, SELECTORS,
                                        ClientSelector,
                                        ClusteredSamplingSelector,
                                        DivFLSelector, FedCorSelector,
                                        FunctionalSelector, HiCSFLSelector,
                                        Observations, PowerOfChoiceSelector,
                                        RandomSelector, SelectNoise,
                                        SelectorState, hics_functional,
                                        make_functional, make_selector)

__all__ = ["ClientSelector", "ClusteredSamplingSelector", "DivFLSelector",
           "FUNCTIONAL", "FedCorSelector", "FunctionalSelector",
           "HiCSFLSelector", "Observations", "PowerOfChoiceSelector",
           "RandomSelector", "SELECTORS", "SelectNoise", "SelectorState",
           "agglomerate", "agglomerate_device", "anneal", "anneal_device",
           "cluster_means", "cluster_means_device", "cluster_probs",
           "coverage_sweep_device", "delta_b_from_head_delta",
           "dissimilarity_envelope", "distance_matrix",
           "entropy_separation_bound", "estimate_entropy",
           "expected_bias_update", "gumbel_topk", "head_bias_update",
           "head_bias_updates_stacked", "head_num_classes",
           "hics_functional", "hierarchical_sample",
           "hierarchical_sample_device", "label_entropy", "make_functional",
           "make_selector", "pairwise_arccos", "sampling_probabilities",
           "silhouette_hint", "softmax_entropy", "weighted_sample_device"]
