"""Sharding rules of the port: the model axis of the (clients, model)
mesh and the client dimension."""
from .rules import (P, STACKED_KEYS, client_dim_flags, client_model_specs,
                    model_specs, pad_client_dim, spec_for_leaf,
                    state_specs_like)
