"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, 2:1 pattern [arXiv:2402.19427]."""
from ..models.layers import ModelConfig
from .common import ArchSpec, FedExec

_FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, mlp="geglu", lru_width=2560,
    hybrid_pattern=("rec", "rec", "attn"), sliding_window=2048,
    conv_width=4, tie_embeddings=True, dtype="bfloat16",
)

_SMOKE = _FULL.replace(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                       head_dim=32, d_ff=256, vocab=512, lru_width=128,
                       sliding_window=16, dtype="float32")

SPEC = ArchSpec(
    arch_id="recurrentgemma-2b",
    source="arXiv:2402.19427",
    model=_FULL,
    fed=FedExec(cohort_mode="parallel", cohort_size=32),
    smoke_model=_SMOKE,
    long_context="native",
    notes="(rec,rec,attn) x 8 groups + 2 tail rec blocks = 26 layers; "
          "local attention window 2048 (ring cache) + O(1) RG-LRU state "
          "make long_500k native.  10 heads are NOT divisible by the 16-way "
          "model axis — the divisibility fallback replicates attention "
          "projections and tensor-shards the 7680-wide MLP instead.",
)
