"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, mlp="moe", n_experts=8, moe_top_k=2,
    sliding_window=4096, rope_theta=1_000_000.0, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, n_experts=4,
                       sliding_window=16, dtype="float32")

SPEC = ArchSpec(
    arch_id="mixtral-8x22b",
    source="arXiv:2401.04088",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="native",   # SWA(4096) per assignment -> ring KV cache
    notes="8 experts top-2; sliding-window attention (4096) makes long_500k "
          "native via the ring KV cache; expert dispatch/combine einsums "
          "lower to all-to-all under expert sharding.",
)
