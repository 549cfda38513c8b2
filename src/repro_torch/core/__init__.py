"""F3AST core of the port: availability models, H(r) and its gradient,
selection (Alg. 1 line 4, Alg. 2 and the baselines), the rate EMA,
aggregation, the strategy registry and the federated round.  The names
are the JAX package's ``repro.core`` (``tools/api_surface.json``)."""
from .availability import (AVAILABILITY_REGISTRY, Always, CommBudget,
                           HomeDevices, MarkovClusters, Scarce, SmartPhones,
                           Uneven, make_availability)
from .bitmask import (all_gather_bits, n_words, pack_bits, unpack_bits,
                      unpack_bits_np)
from .hfun import R_MIN, h_grad, h_value, marginal_utility
from .keys import (COMPLETION, KEY_FOLDS, NONEMPTY, get_key_fold,
                   register_key_fold)
from .selection import (TOPK_IMPLS, cohort_ids_from_mask, f3ast_select,
                        fedavg_select, fixed_policy_select, poc_select,
                        uniform_select)
from .rates import RateState, empirical_rate, init_rates, update_rates
from .aggregation import (fedavg_weights, streaming_aggregate_add,
                          streaming_aggregate_init, unbiased_weights,
                          uniform_weights, weighted_aggregate)
from .strategies import (SELECT_IMPLS, STRATEGY_ALIASES, STRATEGY_REGISTRY,
                         RateTrackState, SelectCtx, SelectionStrategy,
                         as_sharded, list_strategies, make_strategy,
                         register_strategy, resolve_strategy, strategy_rates,
                         topk_strategy)
from .algorithms import Algorithm, AlgoState, make_algorithm
from .fedstep import RoundMetrics, make_fed_round
