"""Data of the paper's hyper-cleaning task: the Dirichlet label-skew
partitions (``partition``) and the label-corrupted client sets
(``hyperclean``)."""
from repro_torch.data.hyperclean import HyperCleanData
from repro_torch.data.partition import (dirichlet_class_priors,
                                        dirichlet_partition, label_histogram)

__all__ = ["HyperCleanData", "dirichlet_class_priors", "dirichlet_partition",
           "label_histogram"]
