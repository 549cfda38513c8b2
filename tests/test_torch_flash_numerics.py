"""The arithmetic of the bfloat16 tensor-core flash_attention kernel,
emulated on the CPU, against the plain version ``kernels.ref.sdpa``.

The kernel (``csrc/flash_attention.cu``, bf16 route) forms the scores as
float32 sums of exact bf16 products, runs the online softmax in float32
over tiles of 64 keys (running max from -1e30, exp(x) as 2^(x log2 e),
the sum over the float32 weights P), splits each P into ``hi = bf16(P)``
and ``lo = bf16(P - hi)`` for the bf16 products with V, accumulates in
float32 and rounds the output to bf16 once.  This file repeats that arithmetic in torch and holds every
lane within one bf16 step of the plain output (2^-7 of its magnitude plus
1e-5), the check ``chip_smoke.py`` makes of the kernel on the card.  A
single bf16 P, the usual tensor-core design, breaks that check; the last
test shows it does.

At head_dim 256 the kernel reads Q's fragments from shared memory each
step rather than holding them in registers: the same products, so the
same arithmetic, which the cases at gemma-7b's head_dim emulate; a group
of 5 query heads a KV head (qwen3-14b) is emulated as well.

The kernel skips tiles that the mask hides from every row of a block; the
emulation visits them.  The result is the same: such a tile's weights are
exp(-1e30 - m) = 0, or, before a row's first visible key, are rescaled away
by exp(-1e30 - m) = 0 at that key's tile.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

BF16_STEP = 2.0 ** -7       # one bf16 step is at most 2^-7 of the magnitude
BF16_STEP_ATOL = 1e-5
KEYS = 64                   # keys per K/V tile in the kernel
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
         "window128": dict(causal=True, window=128, softcap=0.0),
         "full": dict(causal=False, window=0, softcap=0.0),
         "softcap30": dict(causal=True, window=0, softcap=30.0)}
# (B, S, H, KV, hd): tests/test_kernels.py's _ATTN_SHAPES
SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 64), (1, 256, 8, 1, 32),
          (1, 512, 4, 2, 128)]
# gemma-7b's head_dim (MHA and GQA) and qwen3-14b's group of 5
WIDE_SHAPES = [(1, 256, 4, 4, 256), (1, 384, 4, 2, 256), (1, 256, 10, 2, 128)]


@pytest.fixture(autouse=True)
def _one_thread():
    """The emulation's matmuls on one intra-op thread (test workers share
    the cores)."""
    with one_intra_op_thread():
        yield


def _inputs(shape, seed):
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, S, n, hd))
                             .astype(np.float32)).to(torch.bfloat16)
            for n in (H, KV, KV)]


def _emulate(q, k, v, *, causal, window, softcap, split_p=True):
    """The kernel's arithmetic on bf16 q (B, Sq, H, hd), k, v (B, Skv, KV,
    hd), over rows folded (position, group head) as the kernel folds them."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    rows = q.float().reshape(B, Sq, KV, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, KV, Sq * G, hd)
    pos = torch.arange(Sq * G) // G
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    scale = ref.attn_scale(hd)
    m = torch.full((B, KV, Sq * G), ref.ATTN_NEG)
    l = torch.zeros(B, KV, Sq * G)
    acc = torch.zeros(B, KV, Sq * G, hd)
    for kt in range(0, Skv, KEYS):
        kp = torch.arange(kt, min(kt + KEYS, Skv))
        s = rows @ kf[:, :, kp].transpose(-1, -2) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        keep = torch.ones(len(pos), len(kp), dtype=torch.bool)
        if causal:
            keep &= kp[None, :] <= pos[:, None]
        if window > 0:
            keep &= kp[None, :] > pos[:, None] - window
        s = torch.where(keep, s, torch.full_like(s, ref.ATTN_NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * corr + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, kp]
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, kp]
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, Sq, H, hd).to(torch.bfloat16)


def _lanes_over_one_step(got, want):
    diff = (got.float() - want.float()).abs()
    over = diff - BF16_STEP * want.float().abs() - BF16_STEP_ATOL
    return int((over > 0).sum())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", SHAPES + WIDE_SHAPES, ids=str)
def test_split_p_within_one_bf16_step(shape, mode):
    q, k, v = _inputs(shape, sum(shape))
    got = _emulate(q, k, v, **MODES[mode])
    want = ref.sdpa(q, k, v, **MODES[mode])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _lanes_over_one_step(got, want) == 0


def test_split_p_within_one_bf16_step_long_gqa():
    """(1, 2048, 8, 2, 64) causal: 32 key tiles, G = 4."""
    q, k, v = _inputs((1, 2048, 8, 2, 64), 2048)
    got = _emulate(q, k, v, **MODES["causal"])
    want = ref.sdpa(q, k, v, **MODES["causal"])
    assert _lanes_over_one_step(got, want) == 0


@pytest.mark.parametrize("shape", [(1, 1024, 8, 2, 64), (1, 512, 4, 2, 128)],
                         ids=str)
def test_single_bf16_p_breaks_one_step(shape):
    """The check has teeth: rounding P to bf16 once moves lanes by more than
    one bf16 step, which is why the kernel splits P."""
    q, k, v = _inputs(shape, 7)
    want = ref.sdpa(q, k, v, **MODES["causal"])
    single = _emulate(q, k, v, **MODES["causal"], split_p=False)
    assert _lanes_over_one_step(single, want) > 0
    # and the split, on the same inputs, keeps every lane
    split = _emulate(q, k, v, **MODES["causal"])
    assert _lanes_over_one_step(split, want) == 0
