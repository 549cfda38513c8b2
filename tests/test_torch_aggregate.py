"""The port's plain ``fed_aggregate`` vs the JAX kernel's Pallas
interpreter run (float32 at 1e-6, bf16 at the tolerance of
tests/test_kernels.py), with D not a multiple of the Pallas tile (8192),
and the dict form the fed round uses vs ``weighted_aggregate``; plus the
per-lane bound that holds the CUDA kernel to float32 accumulation."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.aggregation import weighted_aggregate
from repro.kernels.fed_aggregate import fed_aggregate as jfed_aggregate
from repro_torch.kernels.fed_aggregate import (fed_aggregate,
                                               fed_aggregate_tree)
from repro_torch.kernels.ref import fed_aggregate_err_bound

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(k, d)).astype(np.float32),
            rng.random(k).astype(np.float32))


@pytest.mark.parametrize("k,d", [(1, 100), (10, 610), (4, 8193),
                                 (16, 20000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fed_aggregate_matches_interpret(k, d, dtype):
    v, w = _inputs(k, d, seed=k * d)
    vj = jnp.asarray(v).astype(getattr(jnp, dtype))
    want = np.asarray(jfed_aggregate(vj, jnp.asarray(w), interpret=True),
                      np.float32)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    got = fed_aggregate(vt, torch.from_numpy(w))
    assert got.dtype == vt.dtype and tuple(got.shape) == (d,)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    want_t = torch.tensor(want)
    bound = fed_aggregate_err_bound(vt, torch.from_numpy(w), got, want_t)
    assert int(((got.float() - want_t).abs() > bound).sum()) == 0


@pytest.mark.parametrize("accumulate", ["float32_reversed", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_err_bound_separates_f32_from_bf16_accumulation(accumulate, dtype):
    """The bound the card's kernel is held to admits a float32 sum in
    another order and rejects a sum accumulated in bfloat16."""
    v, w = _inputs(10, 1 << 16, seed=11)
    vt = torch.from_numpy(v).to(getattr(torch, dtype))
    wt = torch.from_numpy(w)
    want = fed_aggregate(vt, wt)
    acc_dtype = getattr(torch, accumulate.split("_")[0])
    acc = torch.zeros(vt.shape[1], dtype=acc_dtype)
    for k in reversed(range(vt.shape[0])):
        acc = acc + vt[k].to(acc_dtype) * wt[k].to(acc_dtype)
    got = acc.to(vt.dtype)
    bad = int(((got.float() - want.float()).abs()
               > fed_aggregate_err_bound(vt, wt, got, want)).sum())
    if accumulate == "bfloat16":
        assert bad > 100
    else:
        assert bad == 0


def test_fed_aggregate_tree_matches_weighted_aggregate():
    rng = np.random.default_rng(3)
    k = 10
    deltas = {"w": rng.normal(size=(k, 60, 10)).astype(np.float32),
              "b": rng.normal(size=(k, 10)).astype(np.float32)}
    w = rng.random(k).astype(np.float32)
    w[7:] = 0.0                        # padded cohort slots
    want = weighted_aggregate({n: jnp.asarray(a) for n, a in deltas.items()},
                              jnp.asarray(w))
    got = fed_aggregate_tree({n: torch.from_numpy(a)
                              for n, a in deltas.items()},
                             torch.from_numpy(w))
    assert sorted(got) == ["b", "w"]
    for n in deltas:
        assert tuple(got[n].shape) == deltas[n].shape[1:]
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6)


def test_fed_aggregate_rejects_other_devices():
    with pytest.raises(RuntimeError):
        fed_aggregate(torch.zeros(2, 8, device="meta"),
                      torch.zeros(2, device="meta"))
