"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000; GeGLU, head_dim=256 [arXiv:2403.08295]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, mlp="geglu", rope_theta=10000.0,
    tie_embeddings=True, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
                       head_dim=64, d_ff=512, vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="gemma-7b",
    source="arXiv:2403.08295",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="GeGLU MLP, head_dim=256, MHA (kv=16); tied 256k-vocab embeddings "
          "(MQA is the 2b variant per the model card).",
)
