"""The port's client-sharded engine on on-demand client data, and
``run_spec``'s own launch of its ranks, against the JAX package's
single-device engine: the ``SynthTask`` N-scaling cell
(``test_torch_engine_synth.py``) at d = 2 (butterfly) and 3 (the
all-gather cut), and ``run_spec(RunSpec(mesh_shape=(2,)),
device="cpu")`` with no process group initialized — masks, K_t, |avail|
and r_k bitwise, losses within 1e-5."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.sim.engine_sharded import _selection_comm_bytes as jax_comm
import repro_torch.sim as tsim
from repro_torch.launch.mesh import spawn_ranks

import torch_dist_workers as workers
from test_torch_engine_sharded import ROUNDS, TOL, _jax_streams
from test_torch_engine_synth import _jax_run as jax_synth_run


def test_run_spec_mesh_shape_spawns_its_ranks(tmp_path):
    """The entry point itself: no process group is initialized, so
    ``run_spec`` spawns the two ranks and returns rank 0's result (its
    log lines replayed here)."""
    spec = tsim.RunSpec(rounds=10, mesh_shape=(2,))
    lines = []
    res = tsim.run_spec(spec, device="cpu", log_fn=lines.append)
    assert res.final_metrics["engine"] == "sharded"
    assert len(lines) == 1 and "round    9" in lines[0]
    jres, streams = _jax_streams(spec.replace(mesh_shape=None),
                                 tmp_path / "j.jsonl")
    assert res.sel_history.tobytes() == jres.sel_history.tobytes()
    assert res.rates.tobytes() == jres.rates.tobytes()
    np.testing.assert_array_equal(res.k_t, streams["k_t"])
    np.testing.assert_allclose(res.train_loss, streams["train_loss"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("shards,impl", [(2, "stream"), (3, "allgather")])
def test_synth_sharded_engine_bitwise_jax(shards, impl):
    n, seed = 300, 3
    got = spawn_ranks(workers.synth_engines, shards, n, ROUNDS, 10, impl,
                      seed, threads=1)[0]
    want, want_r = jax_synth_run(n, seed)
    for name in ("sel_mask", "completed", "k_t", "n_available"):
        w = getattr(want, name)
        assert w.astype(got[name].dtype).tobytes() == got[name].tobytes()
    assert got["rates"].tobytes() == want_r.tobytes()
    np.testing.assert_allclose(got["train_loss"], want.train_loss, rtol=0,
                               atol=TOL)
    assert got["staged"] == 0
    assert got["comm"] == jax_comm(d=shards, nl=-(-n // (32 * shards)) * 32,
                                   k=10, topk_impl=impl, gathers=1)
