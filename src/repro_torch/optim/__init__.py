from .optimizers import (Optimizer, adam, adamw, apply_updates,
                         make_optimizer, sgd, yogi)
