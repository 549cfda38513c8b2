"""The serving programs over a (data, model) mesh (``build_prefill_step``
and ``build_decode_step`` with ``mesh=``) against the port's one-process
programs and the JAX package's, on gloo ranks on the CPU.

The four dense archs' smoke configs at (2, 2) and (1, 4) and
llama3.2-1b's at (4, 1) (one spawn of 4 ranks a mesh shape,
``spawn_ranks(mesh_shape=, axis_names=("data", "model"))``), each from
JAX's parameters carried across and inputs drawn from a numpy seed:

* the prefill's last-position logits (B = 4, S = 12), gathered from the
  ranks' blocks, within 1e-5 of their largest magnitude of the port's
  one-process prefill, and within ``LOGIT_TOL`` of JAX's unsharded
  ``forward``;
* decode from a zero state, 3 prompt tokens then 3 greedy steps (the
  distributed argmax, each rank's rows fed back): every step's logits
  within the same limits of the one-process ``decode_step`` and of
  JAX's on the same tokens, and the greedy tokens the one-process
  argmax;
* each rank's blocks have the shapes its step's specs give and its
  cache is (B/d, M, KV/m, hd), or every kv head where KV does not divide
  the model axis; the hooks are not left configured.  qwen3-14b's smoke
  config at m = 4 (10 query heads) is the heads fallback: its attention
  runs on the gathered weights, replicated over the model axis;
* JAX's own sharded program (``jax.jit`` with its builders' shardings and
  ``_configure_hooks``, over 4 host devices in a subprocess) on
  llama3.2-1b's smoke config at (2, 2), holding the port's (2, 2) run
  within ``LOGIT_TOL``;
* a (pod, data, model) mesh of (2, 1, 2): the batch over the merged
  (pod, data) group;
* what still raises: the training program and the other families with a
  mesh (ROADMAP.md queue 1 item 11)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import get_model_api  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from torch_parity import one_intra_op_thread  # noqa: E402

DENSE = ["llama3.2-1b", "qwen3-8b", "qwen3-14b", "gemma-7b"]
MESHES = {(2, 2): DENSE, (1, 4): DENSE, (4, 1): ["llama3.2-1b"]}
RUNS = [(shape, arch) for shape, archs in MESHES.items() for arch in archs]
B, S, PROMPT, GREEDY = 4, 12, 3, 3
TOL = 1e-5                       # against the port's one-process programs
LOGIT_TOL = 1e-4                 # against JAX's (test_torch_transformer's)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(arch: str, seed: int) -> dict:
    cfg = jconfigs.get_arch(arch).smoke_model
    params = jget_model_api(cfg).init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return dict(arch=arch, seed=seed,
                params=jax.tree.map(np.asarray, params),
                tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                prompt=rng.integers(0, cfg.vocab, (B, PROMPT)
                                    ).astype(np.int32),
                greedy=GREEDY, max_len=PROMPT + GREEDY + 2)


def _fed(case, run):
    """The tokens each decode step was fed: the prompt, then the greedy
    tokens of the steps before."""
    return np.concatenate([case["prompt"],
                           run["greedy"][:, PROMPT - 1:-1]], axis=1)


@pytest.fixture(scope="module")
def cases():
    return {a: _case(a, seed) for seed, a in enumerate(DENSE)}


@pytest.fixture(scope="module")
def runs(cases):
    """{mesh shape: every rank's results, one list a rank}: one spawn of
    4 gloo ranks a mesh shape."""
    out = {}
    with one_intra_op_thread():
        for shape, archs in MESHES.items():
            out[shape] = spawn_ranks(workers.mesh_serve, 4,
                                     [cases[a] for a in archs],
                                     mesh_shape=shape,
                                     axis_names=("data", "model"), threads=1)
    return out


def _run(runs, shape, arch, rank=0):
    return runs[shape][rank][MESHES[shape].index(arch)]


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max()
                 / np.abs(np.asarray(want, np.float32)).max())


@pytest.fixture(scope="module")
def one_process(cases):
    """{arch: (prefill logits, decode logits a step)} of the port's
    one-process programs, the decode fed each mesh run's tokens."""
    def ref(case, fed):
        cfg = get_arch(case["arch"]).smoke_model
        api = get_model_api(cfg)
        p = params_from_numpy(case["params"], device="cpu")
        pre = api.prefill(p, {"tokens": torch.from_numpy(case["tokens"])})
        st = api.init_decode_state(B, case["max_len"], "cpu")
        steps = []
        for t in range(fed.shape[1]):
            lg, st = api.decode_step(p, st, torch.from_numpy(fed[:, t:t + 1]))
            steps.append(lg.numpy())
        return pre.numpy(), np.stack(steps)
    return ref


@pytest.fixture(scope="module")
def jax_ref(cases):
    """JAX's unsharded forward (last position) and decode_step, jitted."""
    memo = {}

    def ref(case, fed):
        arch = case["arch"]
        cfg = jconfigs.get_arch(arch).smoke_model
        api = jget_model_api(cfg)
        if arch not in memo:
            memo[arch] = (jax.jit(lambda p, b: api.forward(p, b)[0][:, -1:]),
                          jax.jit(api.decode_step))
        fwd, step = memo[arch]
        params = jax.tree.map(jnp.asarray, case["params"])
        pre = np.asarray(fwd(params, {"tokens": jnp.asarray(case["tokens"])}))
        st = api.init_decode_state(B, case["max_len"])
        steps = []
        for t in range(fed.shape[1]):
            lg, st = step(params, st, jnp.asarray(fed[:, t:t + 1]))
            steps.append(np.asarray(lg))
        return pre, np.stack(steps)
    return ref


@pytest.mark.parametrize("shape,arch", RUNS)
def test_mesh_programs_match_one_process_and_jax(shape, arch, cases, runs,
                                                 one_process, jax_ref):
    case = cases[arch]
    run = _run(runs, shape, arch)
    fed = _fed(case, run)
    pre, dec = one_process(case, fed)
    assert _err(run["prefill"], pre) <= TOL
    assert _err(run["decode"], dec) <= TOL
    np.testing.assert_array_equal(run["greedy"], dec.argmax(-1)[..., 0].T)
    jpre, jdec = jax_ref(case, fed)
    assert _err(run["prefill"], jpre) <= LOGIT_TOL
    assert _err(run["decode"], jdec) <= LOGIT_TOL
    for r in range(1, 4):        # every rank gathered the same logits
        other = _run(runs, shape, arch, r)
        np.testing.assert_array_equal(other["prefill"], run["prefill"])
        np.testing.assert_array_equal(other["greedy"], run["greedy"])


@pytest.mark.parametrize("shape,arch", RUNS)
def test_each_rank_holds_its_blocks(shape, arch, cases, runs):
    d, m = shape
    cfg = get_arch(arch).smoke_model
    full = sum(x.size for x in jax.tree.leaves(cases[arch]["params"]))
    for r in range(4):
        run = _run(runs, shape, arch, r)
        assert run["local_shapes"] == run["want_shapes"]
        assert not run["hooks_left"]
        assert run["state_index"] == PROMPT + GREEDY
        kv_split = cfg.n_kv_heads % m == 0
        kv = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
        assert run["cache_shape"] == (cfg.n_layers, B // d, PROMPT + GREEDY
                                      + 2, kv, cfg.head_dim)
        if m == 1:
            assert run["stored"] == full
        else:
            assert run["stored"] < full


def test_heads_fallback_runs_every_head(runs):
    """qwen3-14b's smoke config (10 query heads, 2 kv heads) at m = 4:
    JAX maps ``q_seq`` to the model axis; the port maps no axis to the
    heads, gathers the attention weights and computes every head on
    every rank, with the whole cache."""
    run = _run(runs, (1, 4), "qwen3-14b")
    assert run["mapping"]["heads"] is None
    assert run["mapping"]["kv_heads"] is None
    assert run["cache_shape"][3] == 2
    llama = _run(runs, (1, 4), "llama3.2-1b")       # 8 heads, 2 kv heads
    assert llama["mapping"]["heads"] == "model"
    assert llama["mapping"]["kv_heads"] is None


def test_pod_data_model_mesh(cases, one_process):
    """A (pod, data, model) mesh of (2, 1, 2) over 4 gloo ranks: the
    batch splits over pod and data together (their merged group), and
    the programs match the one-process ones."""
    case = cases["llama3.2-1b"]
    with one_intra_op_thread():
        ranks = spawn_ranks(workers.mesh_serve_pod, 4, (2, 1, 2), [case],
                            threads=1)
    run = ranks[0][0]
    pre, dec = one_process(case, _fed(case, run))
    assert _err(run["prefill"], pre) <= TOL
    assert _err(run["decode"], dec) <= TOL
    assert [r[0]["data_index"] for r in ranks] == [0, 0, 1, 1]
    assert [r[0]["cache_shape"][1] for r in ranks] == [B // 2] * 4


_JAX_SHARDED = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch
    from repro.launch import steps
    from repro.launch.mesh import _grid_mesh
    from repro.models import get_model_api

    io = np.load(sys.argv[1])
    spec = get_arch("llama3.2-1b")
    spec = dataclasses.replace(spec, model=spec.smoke_model)
    cfg = spec.smoke_model
    mesh = _grid_mesh((2, 2), ("data", "model"))
    params = get_model_api(cfg).init_params(
        jax.random.PRNGKey(int(io["seed"])))
    fn, _, in_sh, out_sh = steps.build_prefill_step(spec, "prefill_32k",
                                                    mesh)
    pre = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)(
        jax.device_put(params, in_sh[0]),
        jax.device_put({"tokens": jnp.asarray(io["tokens"])}, in_sh[1]))
    fn, _, in_sh, out_sh = steps.build_decode_step(spec, "decode_32k", mesh)
    step = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh)
    p = jax.device_put(params, in_sh[0])
    fed = io["fed"]
    st = jax.device_put(get_model_api(cfg).init_decode_state(
        fed.shape[0], int(io["max_len"])), in_sh[1])
    out = []
    for t in range(fed.shape[1]):
        lg, st = step(p, st, jax.device_put(jnp.asarray(fed[:, t:t + 1]),
                                            in_sh[2]))
        out.append(np.asarray(lg))
    assert len(pre.sharding.device_set) == 4
    np.savez(sys.argv[2], prefill=np.asarray(pre), decode=np.stack(out))
""")


def test_jax_sharded_program_at_2x2(cases, runs, tmp_path):
    case = cases["llama3.2-1b"]
    run = _run(runs, (2, 2), "llama3.2-1b")
    inp, out = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, seed=case["seed"], tokens=case["tokens"],
             fed=_fed(case, run), max_len=case["max_len"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _JAX_SHARDED, str(inp),
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)
    assert _err(run["prefill"], got["prefill"]) <= LOGIT_TOL
    assert _err(run["decode"], got["decode"]) <= LOGIT_TOL


def test_debug_mesh_program_is_the_one_card_program(cases):
    """On one process ``make_debug_mesh()`` is (1, 1): the sharded
    program's blocks are the whole leaves and its logits the one-card
    program's bits; ``build_step`` dispatches to it."""
    case = cases["llama3.2-1b"]
    arch = workers._smoke_arch("llama3.2-1b")
    mesh = make_debug_mesh()
    step = tsteps.build_step(arch, "prefill_32k", mesh)
    assert isinstance(step, tsteps.MeshStep) and step.kind == "prefill"
    fn, args, in_specs, out_specs = step
    params = params_from_numpy(case["params"], device="cpu")
    batch = {"tokens": torch.from_numpy(case["tokens"])}
    got = fn(*step.shard((params, batch), B))
    want = get_model_api(arch.model).prefill(params, batch)
    assert torch.equal(got, want)
    assert out_specs == ("data", None, "model")
    dec = tsteps.build_step(arch, "decode_32k", mesh)
    assert dec.kind == "decode" and len(tuple(dec)) == 4


def test_what_still_raises_names_item_11():
    mesh = make_debug_mesh()
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tsteps.build_train_step(get_arch("llama3.2-1b"), "train_4k", mesh)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tsteps.build_step(get_arch("llama3.2-1b"), "train_4k", mesh)
    for arch in ("mixtral-8x22b", "mamba2-2.7b", "recurrentgemma-2b",
                 "llava-next-34b", "whisper-small"):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            tsteps.build_prefill_step(get_arch(arch), "prefill_32k", mesh)
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        tsteps.build_decode_step(get_arch("mamba2-2.7b"), "long_500k", mesh)
    assert dataclasses.is_dataclass(tsteps.MeshStep)
