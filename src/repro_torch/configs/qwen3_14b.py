"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm [hf:Qwen/Qwen3-8B]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, mlp="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=320, n_heads=10, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="qwen3-14b",
    source="hf:Qwen/Qwen3-8B",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="qk_norm, GQA 40/8; d_ff=17408 = 17408 (1088 per 16-way shard).",
)
