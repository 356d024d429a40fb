"""Data of the paper's tasks and of the LM trainer: the Dirichlet
label-skew partitions (``partition``), the label-corrupted client sets of
hyper-cleaning (``hyperclean``) and the synthetic non-iid federated token
streams (``synthetic``)."""
from repro_torch.data.hyperclean import HyperCleanData
from repro_torch.data.partition import (dirichlet_class_priors,
                                        dirichlet_partition, label_histogram)
from repro_torch.data.synthetic import (FederatedLMData, TorchLMDraws,
                                        make_client_batch, make_cohort_batch)

__all__ = ["FederatedLMData", "HyperCleanData", "TorchLMDraws",
           "dirichlet_class_priors", "dirichlet_partition",
           "label_histogram", "make_client_batch", "make_cohort_batch"]
