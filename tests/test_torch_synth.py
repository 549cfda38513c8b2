"""On-demand client data (``repro_torch.data.SynthTask``) and the cohort
gathers against the JAX package: ``client_block`` bitwise jitted JAX's for
ids {0, 1, N − 1} and 64 random ids at two seeds (features and labels
both: the label dot is spelled in XLA:CPU's order, which
``test_label_dot_order_is_xla_cpus`` pins on its own), ``synth_cohort_batch``
bitwise JAX's, the staged gather of ``stage_synth_task`` bitwise the
on-demand one, and ``stage_client_arrays(mesh=...)`` padded to
(shards × 32) with sample count 1."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.data import synthetic as jsyn
from repro.data.pipeline import synth_cohort_batch as jax_synth_batch
from repro_torch import random as tr
from repro_torch.data import (SHARD_PAD_QUANTUM, SynthTask,
                              stage_client_arrays, stage_synth_task,
                              staged_cohort_batch, synth_cohort_batch)
from repro_torch.data.synthetic import _dot_4_chains
from repro_torch.launch.mesh import ClientMesh
from torch_parity import one_intra_op_thread

N = 1_000_000


@pytest.fixture(autouse=True)
def _one_thread():
    """Test workers share the cores: one intra-op thread a test."""
    with one_intra_op_thread():
        yield


def _ids(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0, 1, n - 1],
                           rng.integers(0, n, 64)]).astype(np.int32)


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (5, dict(alpha=0.3, beta=0.7)),
    (2, dict(dim=60, n_classes=7, samples_per_client=20))])
def test_client_block_bitwise_jitted_jax(seed, kw):
    ids = _ids(N, seed)
    want = jax.jit(jsyn.SynthTask(n_clients=N, seed=seed, **kw)
                   .client_block)(jnp.asarray(ids))
    got = SynthTask(n_clients=N, seed=seed, **kw).client_block(
        torch.from_numpy(ids))
    assert got["x"].dtype == torch.float32 and got["y"].dtype == torch.int32
    assert got["x"].numpy().tobytes() == np.asarray(want["x"]).tobytes()
    assert (got["y"].numpy() != np.asarray(want["y"])).sum() == 0


def test_rows_depend_only_on_their_id():
    task = SynthTask(n_clients=300, seed=4)
    ids = torch.tensor([7, 250, 7, 3])
    both = task.client_block(ids)
    one = task.client_block(ids[1:2])
    assert both["x"][1].numpy().tobytes() == one["x"][0].numpy().tobytes()
    assert both["x"][0].numpy().tobytes() == both["x"][2].numpy().tobytes()


def test_label_dot_order_is_xla_cpus():
    """The logits' (S, D) @ (D, C) of a client: four FMA chains, then
    (c0 + c1) + (c2 + c3) — bitwise jitted ``vmap(einsum)`` on the same
    inputs, at D = 32 and 60, where a left-to-right sum is not."""
    rng = np.random.default_rng(1)
    for d in (32, 60):
        x = rng.normal(size=(10, 64, d)).astype(np.float32)
        w = rng.normal(size=(10, d, 10)).astype(np.float32)
        want = np.asarray(jax.jit(jax.vmap(
            lambda a, b: jnp.einsum("sd,dc->sc", a, b)))(x, w))
        got = _dot_4_chains(torch.from_numpy(x), torch.from_numpy(w))
        assert got.numpy().tobytes() == want.tobytes(), d
        assert torch.bmm(torch.from_numpy(x), torch.from_numpy(w)).numpy() \
            .tobytes() != want.tobytes()


def test_synth_cohort_batch_bitwise_jax():
    jtask, ttask = (jsyn.SynthTask(n_clients=N, seed=3),
                    SynthTask(n_clients=N, seed=3))
    for trial in range(3):
        ids = _ids(N, trial)[:10]
        want = jax.jit(lambda k, i: jax_synth_batch(jtask, k, i, 5, 20))(
            jax.random.PRNGKey(trial), jnp.asarray(ids))
        got = synth_cohort_batch(ttask, tr.PRNGKey(trial, device="cpu"),
                                 torch.from_numpy(ids.astype(np.int64)), 5,
                                 20)
        assert set(got) == set(want) == {"x", "y"}
        for name in want:
            assert got[name].numpy().tobytes() == \
                np.asarray(want[name]).tobytes(), (name, trial)


def test_staged_gather_of_materialized_task_equals_on_demand():
    task = SynthTask(n_clients=300, seed=7)
    staged = stage_synth_task(task, "cpu", block=128)
    assert staged.arrays["x"].shape == (300, 64, 32)
    rng = np.random.default_rng(2)
    for trial in range(5):
        key = tr.PRNGKey(trial, device="cpu")
        ids = torch.from_numpy(rng.integers(0, 300, 10))
        want = staged_cohort_batch(staged, key, ids, 5, 20)
        got = synth_cohort_batch(task, key, ids, 5, 20)
        for name in want:
            assert got[name].numpy().tobytes() == \
                want[name].numpy().tobytes(), (name, trial)


@pytest.mark.parametrize("shards", [2, 3])
def test_stage_client_arrays_mesh_pads_to_shard_quantum(shards):
    task = SynthTask(n_clients=300, seed=1)
    whole = stage_synth_task(task, "cpu")
    arrays = {k: v.numpy() for k, v in whole.arrays.items()}
    blocks = [stage_client_arrays(arrays, task.counts().numpy(), "cpu",
                                  mesh=ClientMesh(rank=r, size=shards))
              for r in range(shards)]
    n_pad = int(blocks[0].counts.shape[0])
    assert n_pad % (shards * SHARD_PAD_QUANTUM) == 0 and n_pad >= 300
    assert n_pad < 300 + shards * SHARD_PAD_QUANTUM
    for b in blocks:
        counts = b.counts.numpy()
        assert (counts[:300] == task.samples_per_client).all()
        assert (counts[300:] == 1).all()         # padded clients: inert
    for name, arr in arrays.items():
        cat = np.concatenate([b.arrays[name].numpy() for b in blocks])
        assert cat.shape[0] == n_pad
        np.testing.assert_array_equal(cat[:300], arr, err_msg=name)
        assert not cat[300:].any()
    assert task.bytes_per_client == 64 * (32 * 4 + 4)
