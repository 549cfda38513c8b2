"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000; anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The vision tower is a stub, as in the JAX package: the inputs carry
precomputed patch embeddings (anyres tiling ~ 1024 patch tokens at
vit_dim) and the model implements the projector and the language decoder
that consume them.
"""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, mlp="swiglu", rope_theta=5_000_000.0,
    vit_dim=1024, n_patches=1024, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                       head_dim=32, d_ff=512, vocab=512, vit_dim=64,
                       n_patches=16, dtype="float32")

SPEC = ArchSpec(
    arch_id="llava-next-34b",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    model=_FULL,
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="swa_variant",
    notes="anyres tiling stubbed as 1024 patch tokens prepended to text; "
          "loss masked to text positions; decode is text-only with the "
          "image prefix resident in the KV cache.",
)
