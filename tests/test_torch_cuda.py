"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, which is decided inside the fixture, not at import.  On a machine
with an H100 they run with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports the JAX package, which a
GPU machine need not have.)  ``chip_smoke.py`` covers the same ground at
the main path's sizes and beyond, plus the 300-round main path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


MODES = ("unbiased", "unbiased_frozen", "uniform", "fedavg")


# the kernel's crossover (fed_select.cu's kSmallMax): at and below it the
# one-block path, above it the cooperative one
SMALL_MAX = 8192


@pytest.mark.parametrize("n,k,ties,q", [
    (100, 10, False, 0.5), (4099, 37, True, 0.5), (70000, 5000, False, 0.5),
    (64, 0, False, 0.5), (SMALL_MAX - 1, 700, True, 0.5),
    (SMALL_MAX, 1, False, 0.5), (SMALL_MAX + 1, 999, True, 0.5),
    (5000, 5000, False, 1.0), (1 << 22, 50_000, False, 0.5)])
def test_fed_select_kernel_bitwise(dev, n, k, ties, q):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask
    rng = np.random.default_rng(n)
    scores = (rng.integers(0, 4, n) if ties else rng.normal(size=n)) \
        .astype(np.float32)
    avail = rng.random(n) < q
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    rw = (rng.random(n) * 0.9 + 0.05).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (scores, avail, r, p, rw)]
    gpu = [x.to(dev) for x in cpu]
    kk = torch.tensor(k, dtype=torch.int32)
    mask = fed_select_mask(gpu[0], gpu[1], kk.to(dev))
    assert torch.equal(mask.cpu(), ref.topk_threshold_mask(cpu[0], cpu[1],
                                                           kk))
    for mode in MODES:
        frozen = mode == "unbiased_frozen"
        got = fed_select(gpu[0], gpu[1], kk.to(dev), gpu[2], gpu[3], 1e-3,
                         weight_mode=mode, r_weight=gpu[4] if frozen else None)
        want = ref.fed_select_ref(cpu[0], cpu[1], kk, cpu[2], cpu[3], 1e-3,
                                  weight_mode=mode,
                                  r_weight=cpu[4] if frozen else None)
        assert got[0].cpu().numpy().tobytes() == want[0].numpy().tobytes()
        assert got[1].cpu().numpy().tobytes() == want[1].numpy().tobytes()
        if mode == "fedavg":
            np.testing.assert_allclose(got[2].cpu().numpy(), want[2].numpy(),
                                       rtol=1e-5, atol=0)
        else:
            assert got[2].cpu().numpy().tobytes() == \
                want[2].numpy().tobytes()


@pytest.mark.parametrize("n", (100, 4096, SMALL_MAX, 16_384))
def test_fed_select_both_paths_bitwise(dev, n):
    """Forced through either path, the cut is the plain version's."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask
    rng = np.random.default_rng(n + 1)
    scores = rng.integers(0, 8, n).astype(np.float32)
    avail = rng.random(n) < 0.5
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (scores, avail, r, p)]
    gpu = [x.to(dev) for x in cpu]
    k = int(avail.sum()) // 3
    kk = torch.tensor(k, dtype=torch.int32)
    want = ref.fed_select_ref(cpu[0], cpu[1], kk, cpu[2], cpu[3], 1e-3,
                              weight_mode="uniform")
    for path in ("small", "large"):
        mask = fed_select_mask(gpu[0], gpu[1], k, path=path)
        assert torch.equal(mask.cpu(), want[0])
        got = fed_select(gpu[0], gpu[1], kk.to(dev), gpu[2], gpu[3], 1e-3,
                         weight_mode="uniform", path=path)
        for g, w in zip(got, want):
            assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("n", (100, 1 << 20))
def test_fed_select_cut_on_the_unavailable_value(dev, n):
    """Available clients at -1e30 (the unavailable clients' value) and at
    -inf, and k = N: the cut lands on -1e30, where available and
    unavailable clients tie."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select
    rng = np.random.default_rng(n + 2)
    scores = rng.normal(size=n).astype(np.float32)
    scores[rng.random(n) < 0.1] = np.float32(-1e30)
    scores[rng.random(n) < 0.05] = -np.inf
    avail = rng.random(n) < 0.5
    r = rng.random(n).astype(np.float32)
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    cpu = [torch.from_numpy(x) for x in (scores, avail, r, p)]
    gpu = [x.to(dev) for x in cpu]
    kk = torch.tensor(n, dtype=torch.int32)
    got = fed_select(gpu[0], gpu[1], kk.to(dev), gpu[2], gpu[3], 1e-3)
    want = ref.fed_select_ref(cpu[0], cpu[1], kk, cpu[2], cpu[3], 1e-3)
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.numpy().tobytes()


@pytest.mark.parametrize("k,d,dtype,tol", [(10, 610, "float32", 2e-5),
                                           (3, 8193, "float32", 2e-5),
                                           (10, 4099, "bfloat16", 2e-2)])
def test_fed_aggregate_kernel_allclose(dev, k, d, dtype, tol):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_aggregate import fed_aggregate
    rng = np.random.default_rng(d)
    v = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)) \
        .to(getattr(torch, dtype)).to(dev)
    w = torch.from_numpy(rng.random(k).astype(np.float32)).to(dev)
    got = fed_aggregate(v, w)
    want = ref.fed_aggregate_ref(v, w)
    assert got.dtype == v.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    # float32 accumulation: within one output step of the plain version
    bound = ref.fed_aggregate_err_bound(v, w, got, want)
    assert int(((got.float() - want.float()).abs() > bound).sum()) == 0


ATTN_MODES = [dict(causal=True, window=0, softcap=0.0),
              dict(causal=True, window=128, softcap=0.0),
              dict(causal=False, window=0, softcap=0.0),
              dict(causal=True, window=0, softcap=30.0)]


# (B, Sq, Skv, H, KV, hd): the shapes of tests/test_kernels.py, a ragged
# length with G = 4, cross lengths, the smallest head dim, gemma-7b's
# head dim (MHA, GQA and ragged) and qwen3-14b's group of 5
@pytest.mark.parametrize("shape", [(1, 128, 128, 4, 4, 64),
                                   (2, 256, 256, 4, 2, 64),
                                   (1, 256, 256, 8, 1, 32),
                                   (1, 512, 512, 4, 2, 128),
                                   (2, 1000, 1000, 8, 2, 64),
                                   (1, 100, 300, 4, 1, 16),
                                   (1, 512, 512, 4, 4, 256),
                                   (2, 300, 300, 8, 2, 256),
                                   (1, 1024, 1024, 40, 8, 128)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_flash_attention_kernel_allclose(dev, shape, dtype, tol):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, Sq, Skv, H, KV, hd = shape
    rng = np.random.default_rng(Sq + H)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(getattr(torch, dtype)).to(dev)
               for s in ((B, Sq, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    for mode in ATTN_MODES:
        before = flash_attention.launches
        got = flash_attention(q, k, v, **mode)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = ref.sdpa(q, k, v, **mode)
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=tol, atol=tol, err_msg=str(mode))
        if dtype == "bfloat16":
            assert _lanes_over_one_bf16_step(got, want) == 0, mode


def _lanes_over_one_bf16_step(got, want):
    """Lanes more than one bf16 step (2^-7 of the magnitude, + 1e-5) from the
    plain output: kernel and plain version each round one float32 result
    once (chip_smoke.py's check)."""
    diff = (got.float() - want.float()).abs()
    return int((diff > 2.0 ** -7 * want.float().abs() + 1e-5).sum())


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_flash_attention_reads_strided_inputs(dev, dtype, tol):
    """q, k, v as views of one fused (B, S, H + 2 KV, hd) projection."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(2, 200, 12, 64, generator=gen, device=dev) \
        .to(getattr(torch, dtype))
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attention(q, k, v, causal=True)
    want = ref.sdpa(q, k, v, causal=True)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert _lanes_over_one_bf16_step(got, want) == 0
        # the same as on contiguous copies
        again = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        assert torch.equal(got, again)


@pytest.mark.parametrize("which", ["address", "stride"])
def test_flash_attention_rejects_misaligned_bf16(dev, which):
    """The bf16 route copies 16 bytes at a time: a view that is not 16-byte
    aligned, or whose head stride is not a multiple of 8 elements, raises
    before any launch (it never falls back)."""
    from repro_torch.kernels.flash_attention import flash_attention
    base = torch.randn(1, 64, 4, 72, device=dev).to(torch.bfloat16)
    if which == "address":
        q = base[..., 1:65]                  # 2 bytes past an aligned row
    else:
        q = torch.randn(1, 64, 4 * 68, device=dev).to(torch.bfloat16) \
            .reshape(1, 64, 4, 68)[..., :64]  # head stride 68
    k = v = torch.randn(1, 64, 4, 64, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-8b", "qwen3-14b",
                                  "gemma-7b"])
def test_llama_smoke_prefill_card_matches_cpu(dev, arch):
    """The smoke model's prefill through the kernel (2 launches) against
    the same weights' CPU prefill through the plain attention, for each
    dense arch."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    cfg = get_arch(arch).smoke_model
    params = transformer.init_params(cfg, jr.PRNGKey(0, device="cpu"), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 300)).astype(np.int32))
    want = transformer.prefill(cfg, params, {"tokens": toks})

    def to_dev(tree):
        return ({k: to_dev(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))
    gpu = to_dev(params)
    before = flash_attention.launches
    got = transformer.prefill(cfg, gpu, {"tokens": toks.to(dev)})
    assert flash_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
def test_moe_block_and_top_k_card_match_cpu(dev, arch):
    """``moe_block`` at the smoke widths, S = 300 in groups of 128 (the last
    padded with 84 zero rows, whose router probabilities tie exactly), on
    the card against the CPU on the same weights: the experts and slots
    equal, y within 1e-5, lb_loss within 1e-6; and ``top_k`` of tied rows
    bitwise."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.models import layers
    cfg = get_arch(arch).smoke_model.replace(moe_group_size=128)
    p = layers.init_moe(jr.PRNGKey(0, device="cpu"), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 300, cfg.d_model)).astype(np.float32))
    want, want_aux = layers.moe_block(p, x, cfg)
    want_r = layers.moe_routing(p, x, cfg)
    gp, gx = {k: v.to(dev) for k, v in p.items()}, x.to(dev)
    got, got_aux = layers.moe_block(gp, gx, cfg)
    got_r = layers.moe_routing(gp, gx, cfg)
    assert torch.equal(got_r.idx.cpu(), want_r.idx)
    assert torch.equal(got_r.slot.cpu(), want_r.slot)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(got_aux["lb_loss"]) - float(want_aux["lb_loss"])) \
        <= 1e-6
    tied = torch.tensor([[0.125] * 8, [0.1, 0.3, 0.3, 0.3, 0, 0, 0, 0],
                         [0.25, 0.25, 0, 0, 0.25, 0.25, 0, 0]])
    for k in (1, 2, 3):
        tv, ti = layers.top_k(tied, k)
        gv, gi = layers.top_k(tied.to(dev), k)
        assert torch.equal(gi.cpu(), ti) and torch.equal(gv.cpu(), tv)


def _to_dev(tree, dev):
    return ({k: _to_dev(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(1, 1000, 10, 1, 256),
                                   (1, 700, 14, 2, 128)])
def test_flash_attention_groups_of_10_and_7(dev, shape, dtype, tol):
    """recurrentgemma's layer (one KV head, a group of 10, hd 256) with a
    window of 300 and a ragged S, and a group of 7 (llava's), causal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, H, KV, hd = shape
    rng = np.random.default_rng(H)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(getattr(torch, dtype)).to(dev)
               for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    mode = dict(causal=True, window=300 if KV == 1 else 0, softcap=0.0)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **mode)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.sdpa(q, k, v, **mode)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert _lanes_over_one_bf16_step(got, want) == 0


# whisper-small's attention layers at B = 1, (Sq, Skv, causal): the encoder
# over its 1,500 frames (a ragged edge), the decoder's self-attention at
# its target length of 448 and its cross-attention, 448 queries over the
# 1,500 frames
WHISPER_ATTN = [(1500, 1500, False), (448, 448, True), (448, 1500, False)]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("sq,skv,causal", WHISPER_ATTN)
def test_flash_attention_whisper_layers(dev, sq, skv, causal, dtype, tol):
    """whisper's 12 heads on 12 KV heads at hd 64, non-causal with
    Sq != Skv among them, against the plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(getattr(torch, dtype)).to(dev)
               for s in ((1, sq, 12, 64), (1, skv, 12, 64), (1, skv, 12, 64)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = ref.sdpa(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        assert _lanes_over_one_bf16_step(got, want) == 0


def test_rglru_block_card_matches_cpu(dev):
    """recurrentgemma's RG-LRU block at the smoke widths, S = 1000, float32:
    the card's (its float32 gate GEMMs and scan) within 1e-5 relative of
    the CPU's on the same weights."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.models import ssm
    cfg = get_arch("recurrentgemma-2b").smoke_model
    p = ssm.init_rglru(jr.PRNGKey(0, device="cpu"), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1000, cfg.d_model)).astype(np.float32))
    want = ssm.rglru_block(p, x, cfg)
    got = ssm.rglru_block(_to_dev(p, dev), x.to(dev), cfg).cpu()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "llava-next-34b"])
def test_hybrid_and_vlm_smoke_prefill_card_matches_cpu(dev, arch):
    """The smoke model's prefill through the kernel (one launch an
    attention layer) against the same weights' CPU prefill; S = 300 (past
    recurrentgemma's window of 16), llava's 16 patches before the text."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer
    cfg = get_arch(arch).smoke_model
    params = transformer.init_params(cfg, jr.PRNGKey(0, device="cpu"), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 300)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(2, cfg.n_patches, cfg.vit_dim)).astype(np.float32))
    want = transformer.prefill(cfg, params, batch)
    n_attn = (transformer._hybrid_layout(cfg)[1] if cfg.family == "hybrid"
              else cfg.n_layers)
    before = flash_attention.launches
    got = transformer.prefill(cfg, _to_dev(params, dev),
                              _to_dev(batch, dev))
    assert flash_attention.launches == before + n_attn
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_whisper_smoke_prefill_card_matches_cpu(dev):
    """The encoder-decoder's smoke prefill through the kernel (one launch
    an encoder layer, two a decoder layer) against the same weights' CPU
    prefill; 32 frames and S = 300."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import encdec
    cfg = get_arch("whisper-small").smoke_model
    params = encdec.init_params(cfg, jr.PRNGKey(0, device="cpu"), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 300)).astype(np.int32)),
        "frames": torch.from_numpy(rng.normal(
            size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32))}
    want = encdec.prefill_logits(cfg, params, batch)
    before = flash_attention.launches
    got = encdec.prefill_logits(cfg, _to_dev(params, dev),
                                _to_dev(batch, dev))
    assert flash_attention.launches == before + cfg.n_enc_layers \
        + 2 * cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# (B, S, H, KV, hd): groups of 1, 4 and 5, head dims 16-256, a ragged S
BWD_SHAPES = [(2, 128, 2, 2, 32), (1, 1000, 8, 2, 64), (1, 300, 10, 2, 128),
              (1, 200, 4, 2, 256), (2, 96, 4, 1, 16)]
BWD_MODES = {"causal": dict(causal=True, window=0, softcap=0.0),
             "window64": dict(causal=True, window=64, softcap=0.0),
             "softcap30": dict(causal=True, window=0, softcap=30.0)}


@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("mode", list(BWD_MODES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_kernel_allclose(dev, shape, mode, dtype):
    """The backward kernel against ``ref.sdpa_bwd`` on the same q, k, v,
    o, lse and do (one launch, bitwise on a rerun): float32 within 1e-5 of
    each gradient's largest magnitude; bf16 within one bf16 step of each
    lane plus 1e-5 of that magnitude (chip_smoke.py's limits)."""
    _check_bwd(dev, shape, mode, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,mode", [((1, 1500, 12, 12, 64), "full"),
                                        ((1, 448, 12, 12, 64, 1500), "full")])
def test_flash_attention_bwd_whisper_layers(dev, shape, mode, dtype):
    """whisper's non-causal layers: the encoder over its 1,500 frames, and
    the cross-attention, 448 queries over them (Sq != Skv)."""
    _check_bwd(dev, shape, mode, dtype)


def test_flash_attention_bwd_llama_training_layer_bf16(dev):
    """The bf16 (tensor-core) route at llama3.2-1b's training layer,
    (1, 4096, 32, 8, 64) causal, under the same limits."""
    _check_bwd(dev, (1, 4096, 32, 8, 64), "causal", "bfloat16")


def _check_bwd(dev, shape, mode, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    B, S, H, KV, hd = shape[:5]
    skv = shape[5] if len(shape) > 5 else S
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S + hd)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, n_s, n, hd))
                                    .astype(np.float32)).to(dev).to(dt)
                   for n_s, n in ((S, H), (skv, KV), (skv, KV), (S, H)))
    m = dict(BWD_MODES, full=dict(causal=False, window=0, softcap=0.0))[mode]
    o, lse = ref.sdpa_lse(q, k, v, **m)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, **m)
    assert flash_attention_bwd.launches == before + 1
    again = flash_attention_bwd(q, k, v, o, lse, do, **m)
    want = ref.sdpa_bwd(q, k, v, o, lse, do, **m)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == dt and torch.equal(g, a)
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        if dtype == "float32":
            assert float((g - w).abs().max()) <= 1e-5 * scale
        else:
            over = (g - w).abs() - 2.0 ** -7 * w.abs() - 1e-5 * scale
            assert float(over.max()) <= 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grad_through_vmap_reads_kernel_lse(dev, dtype):
    """The forward kernel's lse within 1e-5 of ``ref.sdpa_lse``, and
    ``vmap(grad)`` over the batch through ``flash_attention`` (as the
    parallel round takes it) equal, bit for bit and in one backward
    launch, to the backward kernel fed the forward kernel's o and lse."""
    from torch.func import grad, vmap
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_lse)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 256, n, 64))
                                    .astype(np.float32)).to(dev).to(dt)
                   for n in (8, 2, 2, 8))
    o, lse = flash_attention_lse(q, k, v, causal=True)
    _, want_lse = ref.sdpa_lse(q, k, v, causal=True)
    assert float((lse - want_lse).abs().max()) <= 1e-5
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=True)

    def loss(q, k, v, do):
        out = flash_attention(q[None], k[None], v[None], causal=True)[0]
        return (out.float() * do.float()).sum()

    before = flash_attention_bwd.launches
    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v, do)
    assert flash_attention_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_llama_smoke_training_card_matches_cpu(dev):
    """``run_arch_smoke`` (3 rounds, the smoke config) on the card, through
    the forward and backward kernels, against the CPU: within 1e-5
    relative."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.launch.train import run_arch_smoke
    before = flash_attention_bwd.launches
    card = run_arch_smoke("llama3.2-1b", log_fn=lambda *a: None, device=dev)
    assert flash_attention_bwd.launches > before
    cpu = run_arch_smoke("llama3.2-1b", log_fn=lambda *a: None,
                         device="cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=0)


# (B, nc, Q, H, P, N): the shapes of tests/test_kernels.py's SSD test, the
# mamba2 smoke config, the ssm case of tests/test_models_consistency.py, a
# ragged one (no dimension a multiple of 4) and two chunks of mamba2-2.7b's
# layer (80 heads: ten blocks of 8)
SSD_SHAPES = [(1, 4, 16, 2, 16, 8), (2, 4, 32, 4, 32, 16),
              (1, 2, 128, 2, 64, 128), (1, 8, 8, 8, 32, 16),
              (2, 2, 8, 8, 16, 16), (1, 3, 13, 5, 10, 7),
              (1, 2, 128, 80, 64, 128)]


def _ssd_inputs(shape, seed):
    """x, B, C ~ N(0, 1), dt = softplus(N(0, 1)), A = -exp(0.3 N(0, 1))."""
    B, nc, Q, H, P, N = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, nc, Q, H, P)).astype(np.float32),
            np.logaddexp(rng.normal(size=(B, nc, Q, H)), 0).astype(np.float32),
            (-np.exp(0.3 * rng.normal(size=H))).astype(np.float32),
            rng.normal(size=(B, nc, Q, N)).astype(np.float32),
            rng.normal(size=(B, nc, Q, N)).astype(np.float32))


def _check_ssd(got, want):
    """The limits of tests/test_kernels.py::test_ssd_chunk_allclose."""
    for g, w, tol in zip(got, want, ((1e-4, 1e-4), (1e-4, 1e-4),
                                     (1e-5, 1e-6))):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_kernel_allclose(dev, shape, dtype):
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(dev)
                        for a in _ssd_inputs(shape, sum(shape)))
    x, Bm, Cm = (t.to(getattr(torch, dtype)) for t in (x, Bm, Cm))
    before = ssd_chunk.launches
    got = ssd_chunk(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    _check_ssd(got, ref.ssd_chunk_ref(x, dt, A, Bm, Cm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_reads_strided_inputs(dev, dtype):
    """x, Bm and Cm as the model passes them: views of one (B, S, H P +
    2 N) row of the convolution's output."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    B, nc, Q, H, P, N = 2, 3, 32, 12, 64, 128
    rng = np.random.default_rng(1)
    xbc = torch.from_numpy(rng.normal(size=(B, nc * Q, H * P + 2 * N))
                           .astype(np.float32)).to(getattr(torch, dtype)).to(dev)
    x = xbc[..., :H * P].reshape(B, nc, Q, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, nc, Q, N)
    Cm = xbc[..., H * P + N:].reshape(B, nc, Q, N)
    assert not x.is_contiguous()
    _, dt, A, _, _ = (torch.from_numpy(a).to(dev)
                      for a in _ssd_inputs((B, nc, Q, H, P, N), 2))
    got = ssd_chunk(x, dt, A, Bm, Cm)
    _check_ssd(got, ref.ssd_chunk_ref(x, dt, A, Bm, Cm))
    # the same as on contiguous copies
    again = ssd_chunk(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous())
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_mamba2_smoke_prefill_card_matches_cpu(dev):
    """The smoke model's prefill through the kernel (one launch a layer)
    against the same weights' CPU prefill through the plain version."""
    from repro_torch import random as jr
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    from repro_torch.models import transformer
    cfg = get_arch("mamba2-2.7b").smoke_model
    params = transformer.init_params(cfg, jr.PRNGKey(0, device="cpu"), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    want = transformer.prefill(cfg, params, {"tokens": toks})

    def to_dev(tree):
        return ({k: to_dev(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))
    before = ssd_chunk.launches
    got = transformer.prefill(cfg, to_dev(params), {"tokens": toks.to(dev)})
    assert ssd_chunk.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


# ssd_chunk_bwd.  The float32 route forms every product in float32; the
# bf16 route forms them on the tensor cores, its float32 operands split
# into bf16 terms (tests/test_torch_ssd_bwd_numerics.py emulates it); both
# sum in float32, in other orders than the plain version: float32 gradients
# within 1e-4 of the lane plus 1e-4 of the largest magnitude; bf16 ones
# (dx, dBm, dCm of bf16 inputs) are one float32 result rounded once on each
# side, so one bf16 step of the lane plus 1e-4 of the largest magnitude
# (chip_smoke.py's SSD_BWD_TOL).
def _check_ssd_bwd(got, want, dtype):
    for name, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        gf, wf = g.float(), w.float()
        scale = float(wf.abs().max())
        bf16 = dtype == "bfloat16" and name in ("dx", "dBm", "dCm")
        rtol = 2.0 ** -7 if bf16 else 1e-4
        over = (gf - wf).abs() - rtol * wf.abs() - 1e-4 * scale
        assert float(over.max()) <= 0.0, name


def _ssd_bwd_inputs(dev, shape, dtype, seed, a_rows=False):
    """(x, dt, A, Bm, Cm) on the card, A one row a batch row with
    ``a_rows``, and the cotangents dy, dstates, ddecays ~ N(0, 1)."""
    B, nc, Q, H, P, N = shape
    ins = [torch.from_numpy(a).to(dev) for a in _ssd_inputs(shape, seed)]
    rng = np.random.default_rng(seed + 1)
    if a_rows:
        ins[2] = torch.from_numpy((-np.exp(0.3 * rng.normal(size=(B, H))))
                                  .astype(np.float32)).to(dev)
    for i in (0, 3, 4):
        ins[i] = ins[i].to(getattr(torch, dtype))
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((B, nc, Q, H, P), (B, nc, H, N, P), (B, nc, H))]
    return ins, cots


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_bwd_kernel_allclose(dev, shape, dtype):
    """The backward kernel against ``ref.ssd_chunk_bwd``, one launch, and
    a rerun bitwise."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    ins, cots = _ssd_bwd_inputs(dev, shape, dtype, sum(shape))
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(*ins, *cots)
    torch.cuda.synchronize()
    assert ssd_chunk_bwd.launches == before + 1
    _check_ssd_bwd(got, ref.ssd_chunk_bwd(*ins, *cots), dtype)
    for g, a in zip(got, ssd_chunk_bwd(*ins, *cots)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("shape", [(2, 32, 128, 80, 64, 128),
                                   (2, 3, 40, 12, 24, 56)],
                         ids=["training_layer", "not_multiples_of_16"])
def test_ssd_chunk_bwd_bf16_tensor_cores(dev, shape):
    """The bf16 route (tensor cores) at mamba2-2.7b's training layer as the
    cohort folds it, one A a row, and at a Q, N and P that are not
    multiples of 16 (zero-padded to the 16-wide tiles): against
    ``ref.ssd_chunk_bwd``, one launch, a rerun bitwise."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    ins, cots = _ssd_bwd_inputs(dev, shape, "bfloat16", 17, a_rows=True)
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(*ins, *cots)
    torch.cuda.synchronize()
    assert ssd_chunk_bwd.launches == before + 1
    _check_ssd_bwd(got, ref.ssd_chunk_bwd(*ins, *cots), "bfloat16")
    for g, a in zip(got, ssd_chunk_bwd(*ins, *cots)):
        assert torch.equal(g, a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_bwd_folded_cohort_one_launch(dev, dtype):
    """``vmap(grad)`` through ``ssd_chunk`` over a cohort of 3 clients,
    each with its own A (the round from its second local step on): one
    backward launch, equal bit for bit to the kernel called on the folded
    batch with one A a row, which is within its limits of the plain
    version."""
    from torch.func import grad, vmap
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    ins, cots = _ssd_bwd_inputs(dev, (3, 2, 32, 12, 32, 16), dtype, 11,
                                a_rows=True)
    want = ssd_chunk_bwd(*ins, *cots)
    _check_ssd_bwd(want, ref.ssd_chunk_bwd(*ins, *cots), dtype)

    def loss(x, dt, A, Bm, Cm, dy, dst, ddec):
        y, st, dec = ssd_chunk(x[None], dt[None], A, Bm[None], Cm[None])
        return (y[0] * dy).sum() + (st[0] * dst).sum() + (dec[0] * ddec).sum()

    before = ssd_chunk_bwd.launches
    got = vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(*ins, *cots)
    assert ssd_chunk_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_one_chunk_gradient_skips_the_states_pass(dev, dtype):
    """``grad`` through a one-chunk ``ssd``, which reads neither states nor
    decays: autograd passes None for both, and the gradient is the
    kernel's called with None for them, bit for bit, one launch."""
    from torch.func import grad
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd, ssd_chunk_bwd
    (x, dt, A, Bm, Cm), (dy, _, _) = _ssd_bwd_inputs(
        dev, (2, 1, 64, 8, 32, 16), dtype, 13)
    dy = dy.to(x.dtype).float()        # what reaches y through its rounding
    want = ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, None, None)
    _check_ssd_bwd(want, ref.ssd_chunk_bwd(x, dt, A, Bm, Cm, dy, None, None),
                   dtype)
    before = ssd_chunk_bwd.launches
    got = grad(lambda *a: (ssd(*a, 64).float() * dy[:, 0]).sum(),
               argnums=(0, 1, 2, 3, 4))(x[:, 0], dt[:, 0], A, Bm[:, 0],
                                        Cm[:, 0])
    assert ssd_chunk_bwd.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w.reshape(g.shape))


def test_mamba2_smoke_training_card_matches_cpu(dev):
    """``run_arch_smoke`` (3 rounds, the smoke config) on the card, through
    the ssd_chunk forward and backward kernels, against the CPU's plain
    path: within 1e-5 relative."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    from repro_torch.launch.train import run_arch_smoke
    before = ssd_chunk_bwd.launches
    card = run_arch_smoke("mamba2-2.7b", log_fn=lambda *a: None, device=dev)
    assert ssd_chunk_bwd.launches > before
    cpu = run_arch_smoke("mamba2-2.7b", log_fn=lambda *a: None,
                         device="cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-5, atol=0)
