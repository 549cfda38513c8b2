from .optimizers import Optimizer, apply_updates, make_optimizer, sgd
