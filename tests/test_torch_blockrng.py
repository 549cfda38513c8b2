"""The port's slice-consistent draws (``repro_torch.core.blockrng``) and
the blockwise availability step against the JAX package: ``block_bits``,
``block_uniform`` and ``block_bernoulli`` bitwise JAX's ``block_*`` and
the slices of JAX's full draws (tail lanes past N included: JAX's helpers
read 0 there under the partitionable threefry), and
``Bernoulli.step_block`` / ``force_nonempty_block`` over 2 and 3 gloo
ranks bitwise JAX's full-width ``step`` / ``force_nonempty`` (sigma 0 and
1, and all-down rounds)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import blockrng as jblock
from repro.core.availability import force_nonempty
from repro.sim.processes import make_process as jax_make_process
from repro_torch import random as tr
from repro_torch.core import blockrng as tblock
from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as workers
from torch_parity import one_intra_op_thread


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the cores: one intra-op thread a test."""
    with one_intra_op_thread():
        yield


def _u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().astype(np.uint32)


@pytest.mark.parametrize("n", [7, 64, 101, 1000, 1001])
def test_block_bits_and_uniform_match_jax_and_slices(n):
    jkey, tkey = jax.random.PRNGKey(n), tr.PRNGKey(n, device="cpu")
    bits_full = np.asarray(jax.random.bits(jkey, (n,), jnp.uint32))
    unif_full = np.asarray(jax.random.uniform(jkey, (n,)))
    m = (n + 1) // 2
    # head, straddling the old counter midpoint, tail, and past the tail
    windows = [(0, min(8, n)), (max(0, m - 3), min(7, n - max(0, m - 3))),
               (max(0, n - 5), 5), (max(0, n - 3), 16)]
    for off, nl in windows:
        got_b = _u32(tblock.block_bits(tkey, n, off, nl))
        got_u = tblock.block_uniform(tkey, n, off, nl).numpy()
        assert got_b.tobytes() == np.asarray(
            jblock.block_bits(jkey, n, off, nl)).tobytes(), (off, nl)
        assert got_u.tobytes() == np.asarray(
            jblock.block_uniform(jkey, n, off, nl)).tobytes(), (off, nl)
        real = max(0, min(nl, n - off))
        assert got_b[:real].tobytes() == bits_full[off:off + real].tobytes()
        assert got_u[:real].tobytes() == unif_full[off:off + real].tobytes()
        assert not got_b[real:].any() and not got_u[real:].any()


def test_block_bernoulli_matches_slice_heterogeneous():
    n, off, nl = 500, 123, 77
    q = np.asarray(jnp.linspace(0.05, 0.9, n))
    full = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(3),
                                           jnp.asarray(q)))
    got = tblock.block_bernoulli(tr.PRNGKey(3, device="cpu"),
                                 torch.from_numpy(q[off:off + nl].copy()), n, off,
                                 nl).numpy()
    np.testing.assert_array_equal(got, full[off:off + nl])
    assert tblock.have_block_prng(tr.PRNGKey(3, device="cpu"))


@pytest.mark.parametrize("shards", [2, 3])
def test_step_block_and_force_nonempty_block_match_full_width(shards):
    """One spawn of ``shards`` ranks: Bernoulli.step_block at sigma 0 and
    1 with real N below the pad, an all-down q = 0 round (exactly one
    client wakes, the one JAX's step wakes), and force_nonempty_block of
    an all-down mask, each bitwise JAX's full-width step."""
    seed = 11
    cases = [(96 * shards - 17, 0.3, 0.0), (96 * shards - 17, 0.3, 1.0),
             (32 * shards, 0.0, 0.0), (32 * shards - 5, 0.0, 1.0)]
    key = jax.random.PRNGKey(seed)
    n_lin = 64 * shards
    q_lin = np.asarray(jnp.linspace(0.1, 0.8, n_lin))
    got = spawn_ranks(workers.nonempty_cases, shards, seed, cases, q_lin,
                      threads=1)
    for rank_out in got:
        for (n, q, sigma), blk in zip(cases, rank_out):
            _, full = jax_make_process("bernoulli", n, q=q,
                                       sigma=sigma).step(key, (), 0)
            full = np.asarray(full)
            np.testing.assert_array_equal(blk[:n], full,
                                          err_msg=str((n, q, sigma)))
            assert not blk[n:].any()
            if q == 0.0:
                assert full.sum() == 1
        want = np.asarray(force_nonempty(jnp.zeros(n_lin, bool),
                                         jnp.asarray(q_lin),
                                         jax.random.fold_in(key, 1)))
        assert want.sum() == 1
        np.testing.assert_array_equal(rank_out[-1], want)
