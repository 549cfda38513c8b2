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


@pytest.mark.parametrize("n,k,ties", [(100, 10, False), (4099, 37, True),
                                      (70000, 5000, False), (64, 0, False)])
def test_fed_select_kernel_bitwise(dev, n, k, ties):
    from repro_torch.kernels import ref
    from repro_torch.kernels.fed_select import fed_select, fed_select_mask
    rng = np.random.default_rng(n)
    scores = (rng.integers(0, 4, n) if ties else rng.normal(size=n)) \
        .astype(np.float32)
    avail = rng.random(n) < 0.5
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
