"""The port's model-axis sharding rules (``repro_torch.sharding.rules``)
against the JAX package's (``repro.sharding.rules``), as the JAX
package's own ``tests/test_sharding.py`` tests them.

The JAX side runs on a ``jax.sharding.AbstractMesh`` (no devices needed),
the port's on a dict-backed stand-in with the same ``shape``.  A JAX spec
is compared as the tuple of its entries, entry for entry:

* ``model_specs`` of every arch's ``param_specs`` (JAX's
  ``launch/specs.py`` against the port's), full configs, at model sizes
  1, 2, 4, 8 and 16, with and without an FSDP axis, and the paths the
  name hints read;
* ``spec_for_leaf`` with ``fsdp_axes`` (fused and not), the
  recurrentgemma head fallback, mamba2's vocab case, and any shape
  (hypothesis, as the JAX package's property test);
* ``client_model_specs`` and ``state_specs_like`` (sgd and adam states
  of each arch, and the rejection of a state that does not mirror the
  parameters)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, get_arch as jax_get_arch
from repro.launch.specs import param_specs as jax_param_specs
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.sharding import rules as jr
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.launch.specs import param_specs as torch_param_specs
from repro_torch.optim import make_optimizer as torch_make_optimizer
from repro_torch.sharding import rules as tr
from repro_torch.tree import tree_leaves_with_path, tree_unflatten

import torch_dist_workers as workers

try:                      # optional [dev] extra: only the property test
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

MODEL_SIZES = (1, 2, 4, 8, 16)


class _Mesh:
    """The port's mesh stand-in: a ``shape`` mapping, as the rules read."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


class _Key:
    def __init__(self, key):
        self.key = key


def _meshes(sizes):
    return (AbstractMesh(tuple(sizes.values()), tuple(sizes)),
            _Mesh(sizes))


def _has_shape(x):
    return hasattr(x, "shape")


@pytest.fixture(scope="module")
def trees():
    """{arch: (JAX's param ShapeDtypeStructs, the port's ShapeDtypes)}."""
    return {a: (jax_param_specs(jax_get_arch(a).model),
                torch_param_specs(torch_get_arch(a).model)) for a in ARCHS}


def _jax_flat(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [(jr._path_str(p), tuple(s)) for p, s in flat]


def _torch_flat(tree, specs):
    paths = [tr._path_str(p)
             for p, _ in tree_leaves_with_path(tree, _has_shape)]
    return list(zip(paths, tr.specs_up_to(tree, specs)))


@pytest.mark.parametrize("fsdp", [None, ("data",)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_specs_of_every_arch_equal_jax(arch, fsdp, trees):
    jtree, ttree = trees[arch]
    for m in MODEL_SIZES:
        jmesh, tmesh = _meshes({"data": 4, "model": m})
        want = _jax_flat(jr.model_specs(jtree, jmesh, model_axis="model",
                                        fsdp_axes=fsdp))
        got = _torch_flat(ttree, tr.model_specs(ttree, tmesh,
                                                model_axis="model",
                                                fsdp_axes=fsdp))
        assert got == want, (arch, m)
        if m > 1 and fsdp is None:
            assert any("model" in s for _, s in got), (arch, m)


def test_megatron_hints_and_fallbacks_equal_jax():
    """The JAX package's example leaves: hints, the stacked dim, the
    recurrentgemma head fallback, vectors, FSDP fused and not, mamba2's
    vocab (50280 is not divisible by 16)."""
    cases = [
        (("blocks", "attn", "wq"), (16, 2048, 4096), None),
        (("blocks", "attn", "wo"), (16, 4096, 2048), None),
        (("blocks", "mlp", "w1"), (16, 2048, 8192), None),
        (("blocks", "mlp", "w2"), (16, 8192, 2048), None),
        (("embed",), (128256, 2048), None),
        (("unembed",), (2048, 128256), None),
        (("blocks", "mlp", "w1"), (16, 64, 64), None),
        (("groups", "2_attn", "attn", "wq"), (8, 2560, 2550), None),
        (("groups", "2_attn", "attn", "wq"), (8, 2560, 2560), None),
        (("blocks", "attn", "wq"), (8, 30, 34), None),
        (("blocks", "ln1"), (16, 2048), None),
        (("ln_f",), (2048,), None),
        (("t",), (), None),
        (("blocks", "mlp", "w1"), (16, 2048, 8192), ("data",)),
        (("blocks", "mlp", "w1"), (16, 2048, 16 * 300), ("data",)),
        (("blocks", "mlp", "w1"), (16, 2048, 8192), ("pod", "data")),
        (("lstm", 0, "w_i"), (2, 256, 1024), ("data",)),
        (("embed",), (50280, 2560), None),
    ]
    jmesh, tmesh = _meshes({"pod": 2, "data": 16, "model": 16})
    for path, shape, fsdp in cases:
        want = jr.spec_for_leaf(tuple(_Key(p) for p in path),
                                jax.ShapeDtypeStruct(shape, jnp.float32),
                                jmesh, fsdp_axes=fsdp)
        got = tr.spec_for_leaf(path, tr._Shape(shape), tmesh,
                               fsdp_axes=fsdp)
        assert got == tuple(want), (path, shape, fsdp)
    # the JAX package's expected values, on the port
    assert tr.spec_for_leaf(("embed",), tr._Shape((50280, 2560)),
                            tmesh) == (None, "model")
    assert tr.spec_for_leaf(("blocks", "mlp", "w1"),
                            tr._Shape((16, 2048, 8192)), tmesh,
                            fsdp_axes=("data",)) == \
        (None, None, ("model", "data"))


def test_client_model_specs_equal_jax(trees):
    n = 64
    jtree, ttree = trees["llama3.2-1b"]
    extra_j = {"avail": jax.ShapeDtypeStruct((n,), jnp.float32),
               "staged": jax.ShapeDtypeStruct((n, 32, 128), jnp.float32),
               "w1": jax.ShapeDtypeStruct((32, 128), jnp.float32)}
    extra_t = {k: tr._Shape(tuple(v.shape)) for k, v in extra_j.items()}
    for c, m in ((4, 2), (2, 4), (8, 1)):
        jmesh, tmesh = _meshes({"clients": c, "model": m})
        for jt, tt in ((jtree, ttree), (extra_j, extra_t)):
            want = _jax_flat(jr.client_model_specs(jt, jmesh, n))
            got = _torch_flat(tt, tr.client_model_specs(tt, tmesh, n))
            assert got == want, (c, m)
    got = tr.client_model_specs(extra_t, _Mesh({"clients": 4, "model": 2}),
                                n)
    assert got["avail"] == ("clients",)
    assert got["staged"][0] == "clients"
    assert got["w1"] == (None, "model")


def _meta(tree):
    """The ShapeDtype tree as meta tensors (an optimizer's ``init`` takes
    tensors; nothing is allocated)."""
    return tree_unflatten(tree, [
        torch.empty(x.shape, dtype=x.dtype, device="meta")
        for _, x in tree_leaves_with_path(tree, _has_shape)], _has_shape)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "whisper-small"])
def test_state_specs_like_equal_jax(arch, opt, trees):
    jtree, ttree = trees[arch]
    tparams = _meta(ttree)
    jstate = jax.eval_shape(jax_make_optimizer(opt).init, jtree)
    tstate = torch_make_optimizer(opt).init(tparams)
    for m in (2, 16):
        jmesh, tmesh = _meshes({"clients": 2, "model": m})
        jps = jr.model_specs(jtree, jmesh)
        tps = tr.model_specs(tparams, tmesh)
        want = [tuple(s) for s in jax.tree.leaves(
            jr.state_specs_like(jstate, jtree, jps),
            is_leaf=lambda x: isinstance(x, JP))]
        got_tree = tr.state_specs_like(tstate, tparams, tps)
        got = tr.specs_up_to(tstate, got_tree)
        assert got == want, (arch, opt, m)
    if opt == "adam":
        assert got_tree.m == tps and got_tree.v == tps and got_tree.t == ()


def test_state_specs_like_rejects_non_mirroring_state():
    params = {"w1": torch.zeros(32, 128)}
    specs = tr.model_specs(params, _Mesh({"clients": 4, "model": 2}))
    with pytest.raises(ValueError, match="mirror"):
        tr.state_specs_like((0, {"w1": torch.zeros(7, 5)}), params, specs)
    jparams = {"w1": jax.ShapeDtypeStruct((32, 128), jnp.float32)}
    jspecs = jr.model_specs(jparams, AbstractMesh((4, 2),
                                                  ("clients", "model")))
    with pytest.raises(ValueError, match="mirror"):
        jr.state_specs_like((jax.ShapeDtypeStruct((), jnp.int32),
                             {"w1": jax.ShapeDtypeStruct((7, 5),
                                                         jnp.float32)}),
                            jparams, jspecs)


def test_size_one_model_axis_replicates_everything(trees):
    _, ttree = trees["qwen3-8b"]
    specs = tr.model_specs(ttree, _Mesh({"clients": 8, "model": 1}))
    assert all(all(e is None for e in s)
               for s in tr.specs_up_to(ttree, specs))


if HAVE_HYPOTHESIS:
    @settings(max_examples=200, deadline=None)
    @given(st.lists(st.integers(1, 4096), min_size=1, max_size=4),
           st.booleans(), st.sampled_from(["wq", "wo", "embed", "ln"]))
    def test_any_shape_gets_jax_spec(shape, fsdp_on, name):
        """Every shape gets JAX's spec, and a consistent one: each split
        dim divisible by its axes' size, each axis used at most once."""
        jmesh, tmesh = _meshes({"data": 16, "model": 16})
        fsdp = ("data",) if fsdp_on else None
        path = ("blocks", "attn", name)
        got = tr.spec_for_leaf(path, tr._Shape(tuple(shape)), tmesh,
                               fsdp_axes=fsdp)
        want = jr.spec_for_leaf(tuple(_Key(p) for p in path),
                                jax.ShapeDtypeStruct(tuple(shape),
                                                     jnp.float32),
                                jmesh, fsdp_axes=fsdp)
        assert got == tuple(want)
        used = []
        for a in got:
            if a is not None:
                used.extend(a if isinstance(a, tuple) else (a,))
        assert len(used) == len(set(used))
        for dim, axis in zip(shape, got):
            if axis is not None:
                names = axis if isinstance(axis, tuple) else (axis,)
                assert dim % int(np.prod([tmesh.shape[a]
                                          for a in names])) == 0


# ---------------------------------------------------------------------------
# The serving programs' specs (launch.steps with a mesh)
# ---------------------------------------------------------------------------

# the five meshes of the step builders: JAX's production meshes and the
# four-rank ones the port runs
STEP_MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 2, "model": 2}, {"data": 4, "model": 1},
               {"data": 1, "model": 4}]
STEP_DENSE = ["llama3.2-1b", "qwen3-8b", "qwen3-14b", "gemma-7b"]


def _fed_mesh(sizes):
    """The port's FedMesh as a descriptor (rank 0, no process group)."""
    from repro_torch.launch.mesh import ClientMesh, FedMesh
    axes = tuple(ClientMesh(axis=n, size=s) for n, s in sizes.items())
    lead = tuple(sizes)[:-1]
    merged = ((ClientMesh(axis=lead, size=int(np.prod(
        [sizes[a] for a in lead]))),) if len(sizes) >= 3 else ())
    return FedMesh(axes=axes, merged=merged)


@pytest.fixture
def jax_specs(monkeypatch):
    """JAX's sharding functions return the specs their NamedShardings
    would hold (the stand-in meshes have no devices)."""
    import repro.launch.steps as jsteps
    for mod in (jr, jsteps):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)
    yield jsteps
    from repro.sharding import hooks as jhooks
    jhooks.clear()


def _flat_specs(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, (JP, tuple)))
    return [(jr._path_str(p), tuple(s)) for p, s in flat]


def _flat_torch_specs(tree, specs):
    return [(tr._path_str(p), s) for (p, _), s in zip(
        tree_leaves_with_path(tree, _has_shape), tr.specs_up_to(tree, specs))]


@pytest.mark.parametrize("sizes", STEP_MESHES,
                         ids=lambda s: "x".join(map(str, s.values())))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serving_specs_of_every_arch_equal_jax(arch, sizes, trees,
                                               jax_specs):
    """``param_shardings`` (with and without the data axes as FSDP axes),
    ``batch_shardings`` (dim 0 of the prefill batch, dim 2 of the
    cohort's) and ``decode_state_shardings`` at the arch's full config,
    from the shapes alone; ``data_axes`` of each mesh."""
    from repro.launch import mesh as jmesh_mod
    from repro.launch import specs as jspecs
    from repro_torch.launch import mesh as tmesh_mod
    from repro_torch.launch import specs as tspecs
    jmesh, tmesh = _Mesh(sizes), _fed_mesh(sizes)
    daxes = tmesh_mod.data_axes(tmesh)
    assert daxes == jmesh_mod.data_axes(jmesh)
    jtree, ttree = trees[arch]
    for fsdp in (None, daxes):
        want = _flat_specs(jr.param_shardings(jtree, jmesh, fsdp_axes=fsdp))
        got = _flat_torch_specs(ttree, tr.param_shardings(
            ttree, tmesh, fsdp_axes=fsdp))
        assert got == want, (arch, sizes, fsdp)
    jarch, tarch = jax_get_arch(arch), torch_get_arch(arch)
    for shape, dim, jfn, tfn in (
            ("prefill_32k", 0, jspecs.prefill_batch_specs,
             tspecs.prefill_batch_specs),
            ("train_4k", 2, jspecs.cohort_batch_specs,
             tspecs.cohort_batch_specs)):
        jb, tb = jfn(jarch, shape), tfn(tarch, shape)
        want = _flat_specs(jr.batch_shardings(jb, jmesh,
                                              batch_dim_axes=daxes,
                                              batch_dim=dim))
        got = _flat_torch_specs(tb, tr.batch_shardings(
            tb, tmesh, batch_dim_axes=daxes, batch_dim=dim))
        assert got == want, (arch, sizes, shape)
    for shape in ("decode_32k", "long_500k"):
        if jarch.model_for_shape(shape) is None:
            continue
        js = jspecs.decode_state_specs(jarch, shape)
        ts = tspecs.decode_state_specs(tarch, shape)
        want = _flat_specs(jr.decode_state_shardings(js, jmesh,
                                                     data_axes=daxes))
        got = _flat_torch_specs(ts, tr.decode_state_shardings(
            ts, tmesh, data_axes=daxes))
        assert got == want, (arch, sizes, shape)


@pytest.mark.parametrize("sizes", STEP_MESHES,
                         ids=lambda s: "x".join(map(str, s.values())))
def test_mesh_step_specs_equal_jax_builders(sizes, jax_specs):
    """The dense archs' ``MeshStep`` at prefill_32k, decode_32k and
    long_500k: the parameters', the batch's, the token's and the logits'
    specs are those of JAX's builders' shardings, and the hook mapping
    JAX's ``_configure_hooks`` on the axes the port's layers read
    (``heads``, ``kv_heads``, ``tensor``; the port adds ``vocab``).  The decode
    state is held by kv heads where JAX's puts the model axis on
    head_dim: the port's ``decode_state_shardings`` is JAX's, its
    program's own layout departs from it there."""
    from repro.sharding import hooks as jhooks
    from repro_torch.launch import steps as tsteps
    jsteps = jax_specs
    jmesh, tmesh = _Mesh(sizes), _fed_mesh(sizes)
    m = sizes["model"]
    for arch in STEP_DENSE:
        jarch, tarch = jax_get_arch(arch), torch_get_arch(arch)
        cfg = tarch.model
        _, _, (jp, jb), jout = jsteps.build_prefill_step(
            jarch, "prefill_32k", jmesh)
        jmap = dict(jhooks._STATE["axes"])
        step = tsteps.build_prefill_step(tarch, "prefill_32k", tmesh)
        _, targs, (tp, tb), tout = step
        assert _flat_torch_specs(targs[0], tp) == _flat_specs(jp)
        assert _flat_torch_specs(targs[1], tb) == _flat_specs(jb)
        assert tout == tuple(jout)
        assert {k: v for k, v in step.mapping.items() if k != "vocab"} \
            == {k: jmap[k] for k in ("heads", "kv_heads", "tensor")}
        assert step.mapping["vocab"] == ("model" if cfg.vocab % m == 0
                                         else None)
        for shape in ("decode_32k", "long_500k"):
            _, _, (jp, jst, jtok), (jlog, _) = jsteps.build_decode_step(
                jarch, shape, jmesh)
            step = tsteps.build_decode_step(tarch, shape, tmesh)
            _, targs, (tp, tst, ttok), (tlog, _) = step
            assert _flat_torch_specs(targs[0], tp) == _flat_specs(jp)
            assert ttok == tuple(jtok) and tlog == tuple(jlog)
            jmap = jhooks._STATE["axes"]
            assert {k: v for k, v in step.mapping.items()
                    if k != "vocab"} == {k: jmap[k] for k in
                                         ("heads", "kv_heads", "tensor")}
            held = dict(_flat_torch_specs(targs[1], tst))
            jax_held = dict(_flat_specs(jst))
            assert held["index"] == jax_held["index"] == ()
            kv = "model" if cfg.n_kv_heads % m == 0 and m > 1 else None
            for k in ("caches/k", "caches/v"):
                assert held[k][:2] == jax_held[k][:2]     # batch over data
                assert held[k][3] == kv                    # by kv heads
                assert held[k][4] is None
                if m > 1:
                    assert jax_held[k][4] == "model"       # JAX: head_dim
            local = dict((tr._path_str(p), s) for p, s in
                         tree_leaves_with_path(workers.local_shapes(
                             targs[1], tst, tmesh), _has_shape))
            L, Bg, M, KV, hd = targs[1]["caches"]["k"].shape
            d = int(np.prod([sizes[a] for a in sizes if a != "model"]))
            assert local["caches/k"].shape == (
                L, Bg // d if Bg % d == 0 else Bg, M,
                KV // m if kv else KV, hd)
