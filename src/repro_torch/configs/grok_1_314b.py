"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072, mlp="moe", n_experts=8, moe_top_k=2,
    attn_softcap=30.0, rope_theta=10000.0, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, n_experts=4,
                       dtype="float32")

SPEC = ArchSpec(
    arch_id="grok-1-314b",
    source="hf:xai-org/grok-1",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8, server_opt="sgd",
                acc_dtype="bfloat16", seq_parallel=False),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="largest assigned arch (~314B total / ~86B active). Server opt is "
          "SGD: Adam's 2x f32 moments (2.5 TB) do not fit a single v5e pod "
          "next to params+accumulators; with SGD the sharded state is "
          "params + f32 delta accumulator. attn logit softcap 30.0.",
)
