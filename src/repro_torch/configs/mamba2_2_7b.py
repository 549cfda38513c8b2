"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128; SSD state-space duality [arXiv:2405.21060]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    ssm_chunk=128, conv_width=4, tie_embeddings=True, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=128, ssm_state=16, ssm_head_dim=32,
                       vocab=512, ssm_chunk=8, dtype="float32")

SPEC = ArchSpec(
    arch_id="mamba2-2.7b",
    source="arXiv:2405.21060",
    model=_FULL,
    fed=FedExec(cohort_mode="parallel", cohort_size=32),
    smoke_model=_SMOKE,
    long_context="native",
    notes="attention-free; decode state is O(1) in sequence length, so "
          "long_500k runs natively (d_inner=5120, 80 SSD heads).",
)
