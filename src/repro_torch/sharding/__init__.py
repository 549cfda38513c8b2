"""Sharding rules of the port: the client dimension (the model-axis rules
are ROADMAP.md queue 1 item 11)."""
from .rules import client_dim_flags, pad_client_dim
