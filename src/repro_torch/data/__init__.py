"""Synthetic datasets for the port (numpy, no torch needed)."""
from repro_torch.data.synthetic import (SyntheticSpec,
                                        client_label_distributions,
                                        make_classification_data,
                                        make_lm_streams, make_train_test,
                                        pad_and_stack)

__all__ = ["SyntheticSpec", "client_label_distributions",
           "make_classification_data", "make_lm_streams", "make_train_test",
           "pad_and_stack"]
