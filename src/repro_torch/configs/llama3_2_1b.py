"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 [hf:meta-llama/Llama-3.2-1B]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, mlp="swiglu", rope_theta=500000.0,
    tie_embeddings=True, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="llama3.2-1b",
    source="hf:meta-llama/Llama-3.2-1B",
    model=_FULL,
    fed=FedExec(cohort_mode="parallel", cohort_size=32),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="small llama3; tied embeddings; full attention -> long_500k uses "
          "the documented sliding-window variant (DESIGN.md §5).",
)
