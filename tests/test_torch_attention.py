"""The port's plain attention (the CPU path and on-card oracle of the
``flash_attention`` kernel) against the JAX package: the Pallas kernel in
interpret mode, ``kernels.ref.attention_ref`` and both branches of
``models.layers.sdpa`` (dense, and the chunked online softmax above 2048²
scores, with its K/V padding), in every mask and soft-cap mode, with GQA,
MQA and MHA.  Inputs come from numpy with a seed; bf16 inputs carry the
same bits into both packages.

Limits: 2e-5 in float32 and 2e-2 in bfloat16, those of
``tests/test_kernels.py::test_flash_attention_allclose``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODES = [dict(causal=True, window=0, softcap=0.0),
         dict(causal=True, window=128, softcap=0.0),
         dict(causal=False, window=0, softcap=0.0),
         dict(causal=True, window=0, softcap=30.0)]
MODE_IDS = ["causal", "window128", "full", "softcap30"]


def _inputs(B, Sq, Skv, H, KV, hd, dtype, seed):
    """The same q, k, v for both packages: (jax arrays, torch CPU tensors)."""
    rng = np.random.default_rng(seed)
    arrs = {"q": rng.normal(size=(B, Sq, H, hd)),
            "k": rng.normal(size=(B, Skv, KV, hd)),
            "v": rng.normal(size=(B, Skv, KV, hd))}
    jx = {n: jnp.asarray(a, jnp.float32).astype(dtype) for n, a in arrs.items()}
    tx = params_from_numpy({n: np.asarray(a) for n, a in jx.items()},
                           device="cpu")
    return [jx[n] for n in "qkv"], [tx[n] for n in "qkv"]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# (B, S, H, KV, hd, bq, bk): MHA and GQA of tests/test_kernels.py; the
# Pallas interpreter is slow, so two shapes
_PALLAS_SHAPES = [(1, 128, 4, 4, 64, 128, 128), (2, 256, 4, 2, 64, 128, 128)]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", _PALLAS_SHAPES, ids=["mha", "gqa"])
def test_plain_attention_matches_pallas_interpreter(shape, mode):
    B, S, H, KV, hd, bq, bk = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, S, S, H, KV, hd, jnp.float32, 1)
    want = jflash(jq, jk, jv, bq=bq, bk=bk, interpret=True, **mode)
    _close(flash_attention(tq, tk, tv, **mode), want, "float32")


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_pallas_interpreter_at_head_dim_256(dtype,
                                                                    mode):
    """gemma-7b's head_dim, which the TPU kernel takes like any other, on
    a small GQA shape: (1, 128, 4 heads, 2 KV heads, 256), blocks of 64."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 128, 128, 4, 2, 256,
                                         jnp.dtype(dtype), 2)
    want = jflash(jq, jk, jv, bq=64, bk=64, interpret=True, **mode)
    got = flash_attention(tq, tk, tv, **mode)
    assert got.dtype == tq.dtype and tuple(got.shape) == (1, 128, 4, 256)
    _close(got, want, dtype)


# (B, Sq, Skv, H, KV, hd)
_REF_SHAPES = [(1, 128, 128, 4, 4, 64),     # MHA
               (2, 256, 256, 4, 2, 64),     # GQA 2:1
               (1, 256, 256, 8, 1, 32),     # MQA
               (1, 200, 200, 8, 2, 16)]     # ragged length, G = 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("shape", _REF_SHAPES,
                         ids=["mha", "gqa", "mqa", "ragged"])
def test_attention_ref_matches_jax(shape, mode, dtype):
    B, Sq, Skv, H, KV, hd = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Skv, H, KV, hd,
                                         getattr(jnp, dtype), 2)
    want = jref.attention_ref(jq, jk, jv, **mode)
    got = ref.attention_ref(tq, tk, tv, **mode)
    assert got.dtype == tq.dtype
    _close(got, want, dtype)
    # the dense branch of sdpa is the same function
    _close(ref.sdpa(tq, tk, tv, **mode), want, dtype)


# Sq * Skv > 2048² with Sq a multiple of 1024 takes the chunked branch;
# Skv = 2500 is padded to 3072 and the padding masked.
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_chunked_sdpa_matches_jax(mode):
    B, Sq, Skv, H, KV, hd = 1, 2048, 2500, 2, 1, 16
    assert Sq * Skv > ref._CHUNKED_THRESHOLD and Sq % ref._Q_CHUNK == 0
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, Sq, Skv, H, KV, hd, jnp.float32, 3)
    want = jlayers.sdpa(jq, jk, jv, **mode)
    _close(ref.sdpa(tq, tk, tv, **mode), want, "float32")
    # and it agrees with the dense oracle on the same inputs
    _close(ref.attention_ref(tq, tk, tv, **mode),
           jref.attention_ref(jq, jk, jv, **mode), "float32")


def test_chunked_sdpa_bf16_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 2048, 3072, 4, 2, 32,
                                         jnp.bfloat16, 4)
    want = jlayers.sdpa(jq, jk, jv, causal=True)
    _close(ref.sdpa(tq, tk, tv, causal=True), want, "bfloat16")


@pytest.mark.parametrize("q_offset,kv_valid_len", [(5, None), (0, 40),
                                                   (63, 64)])
def test_dense_sdpa_offsets_match_jax(q_offset, kv_valid_len):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 1, 64, 4, 2, 32, jnp.float32, 5)
    kw = dict(causal=True, q_offset=q_offset, kv_valid_len=kv_valid_len)
    _close(ref.sdpa(tq, tk, tv, **kw), jlayers.sdpa(jq, jk, jv, **kw),
           "float32")


def test_cpu_dispatch_runs_the_plain_version():
    _, (tq, tk, tv) = _inputs(1, 96, 96, 4, 2, 32, jnp.float32, 6)
    want = ref.sdpa(tq, tk, tv, causal=True, window=16)
    before = flash_attention.launches
    assert torch.equal(flash_attention(tq, tk, tv, causal=True, window=16),
                       want)
    # the CPU path launches nothing
    assert flash_attention.launches == before


def test_other_devices_raise():
    q = torch.empty(1, 4, 2, 16, device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        flash_attention(q, q, q)
