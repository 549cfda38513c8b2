"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936; qk_norm [hf:Qwen/Qwen3-8B]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151936, mlp="swiglu", qk_norm=True,
    rope_theta=1_000_000.0, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, dtype="float32")

SPEC = ArchSpec(
    arch_id="qwen3-8b",
    source="hf:Qwen/Qwen3-8B",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="qk_norm per-head RMSNorm; GQA 32/8.",
)
