from .synthetic import (SyntheticDataset, make_char_lm_federated,
                        make_synthetic_federated, make_vision_federated)
from .partition import (client_fractions, dirichlet_partition,
                        size_skewed_partition)
from .pipeline import (CohortSampler, FederatedData, StagedData,
                       staged_cohort_batch)
