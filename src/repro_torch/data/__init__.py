from .synthetic import SyntheticDataset, make_synthetic_federated
from .pipeline import (CohortSampler, FederatedData, StagedData,
                       staged_cohort_batch)
