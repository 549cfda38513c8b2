from .synthetic import (SynthTask, SyntheticDataset, make_char_lm_federated,
                        make_synthetic_federated, make_vision_federated)
from .partition import (client_fractions, dirichlet_partition,
                        size_skewed_partition)
from .pipeline import (SHARD_PAD_QUANTUM, CohortSampler, FederatedData,
                       StagedData, stage_client_arrays, stage_synth_task,
                       staged_cohort_batch, synth_cohort_batch)
