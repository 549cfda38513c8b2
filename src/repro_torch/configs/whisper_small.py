"""whisper-small [audio] — 12L d_model=768 12H d_ff=3072 vocab=51865;
encoder-decoder, conv frontend STUB [arXiv:2212.04356].

Frontend carve-out, as in the JAX package: the inputs carry precomputed
frame embeddings (B, 1500, 768) — the mel-spectrogram and the two-conv
stack are a stub; the transformer encoder and the causal decoder with
cross-attention are implemented (``models/encdec.py``).
"""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865, mlp="gelu", use_rope=False,
    enc_seq=1500, tie_embeddings=True, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
                       n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
                       enc_seq=32, dtype="float32")

SPEC = ArchSpec(
    arch_id="whisper-small",
    source="arXiv:2212.04356",
    model=_FULL,
    # sequential despite the small size: 12 heads don't divide the 16-way
    # model axis of the JAX package's mesh
    fed=FedExec(cohort_mode="sequential", cohort_size=8),
    smoke_model=_SMOKE,
    long_context="skip",
    notes="encoder-decoder with architectural max target length 448: "
          "long_500k decode is skipped (DESIGN.md §5); decode_32k lowers as "
          "a shape-stress config (self-attn KV cache at 32k). train_4k uses "
          "a 4096-token teacher-forced decoder sequence.",
)
