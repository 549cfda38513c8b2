"""Sharding rules of the port: the model axis of the (clients, model)
mesh, the client dimension, and the specs and logical-axis hooks of the
serving programs over a (data, model) mesh."""
from . import hooks
from .rules import (P, STACKED_KEYS, batch_shardings, client_dim_flags,
                    client_model_specs, decode_state_shardings,
                    gather_full, local_blocks, model_specs, pad_client_dim,
                    param_shardings, spec_for_leaf, state_specs_like)
