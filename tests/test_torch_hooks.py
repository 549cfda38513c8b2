"""The port's logical-axis hooks (``repro_torch.sharding.hooks``) against
the JAX package's (``repro.sharding.hooks``), as ``tests/test_hooks.py``
tests JAX's: a no-op unconfigured, the divisibility gate and the
rank-mismatch skip, and model outputs unchanged when configured.

JAX's ``constrain`` runs on a mesh stand-in with its
``with_sharding_constraint`` and ``NamedSharding`` replaced inside the
test, so that it returns the spec it would pin; the port's ``axis_for``
must name, dim by dim, the mesh axis that spec names (None where the
gate replicates)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import get_model_api as jget_model_api  # noqa: E402
from repro.sharding import hooks as jhooks  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.mesh import (ClientMesh, FedMesh,  # noqa: E402
                                     make_debug_mesh)
from repro_torch.models import ModelConfig, get_model_api  # noqa: E402
from repro_torch.sharding import hooks  # noqa: E402
from repro_torch.sharding.rules import P  # noqa: E402

MAPPING = {"batch": ("data",), "tensor": "model", "sequence": "model",
           "heads": "model", "kv_heads": None, "q_seq": None,
           "expert": None}
LOGICALS = [("batch", "tensor"), ("batch", None, "tensor"),
            ("batch", "sequence", None), ("batch", "q_seq", "heads", None),
            ("batch", None, "kv_heads", None)]
SHAPES = [(4, 6), (8, 16), (2, 3), (3, 4), (16, 32), (1, 1)]


class _JaxMesh:
    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _port_mesh(sizes) -> FedMesh:
    """A mesh descriptor of rank 0 (no process group: only its shape and
    axes are read)."""
    axes = tuple(ClientMesh(axis=n, size=s) for n, s in sizes.items())
    merged = ()
    if len(sizes) >= 3:
        lead = tuple(sizes)[:-1]
        merged = (ClientMesh(axis=lead, size=int(np.prod(
            [sizes[a] for a in lead]))),)
    return FedMesh(axes=axes, merged=merged)


def _pinned(mapping, shape, logical):
    """The spec the port's hooks give a tensor of ``shape``: each dim's
    mapped axes where ``axis_for`` lets them through its gate."""
    return P(*(mapping[n] if n and hooks.axis_for(n, d) is not None
               else None for d, n in zip(shape, logical)))


def test_noop_when_unconfigured():
    hooks.clear()
    jhooks.clear()
    x = torch.ones((4, 6))
    assert hooks.constrain(x, ("batch", "tensor")) is x
    assert hooks.axis_for("batch", 4) is None
    assert hooks.axis_for("tensor") is None
    assert hooks.current_mesh() is None
    jx = jnp.ones((4, 6))
    assert jhooks.constrain(jx, ("batch", "tensor")) is jx


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 1},
                                   {"data": 2, "model": 2},
                                   {"data": 4, "model": 1},
                                   {"data": 1, "model": 4},
                                   {"pod": 2, "data": 2, "model": 4}])
def test_configured_constrains_and_divisibility_gates(sizes, monkeypatch):
    monkeypatch.setattr(jhooks, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    mapping = dict(MAPPING)
    if "pod" in sizes:
        mapping["batch"] = ("pod", "data")
    mesh = _port_mesh(sizes)
    jhooks.configure(_JaxMesh(sizes), mapping)
    try:
        with hooks.configured(mesh, mapping):
            assert hooks.current_mesh() is mesh
            for logical in LOGICALS:
                for shape in SHAPES:
                    if len(shape) != len(logical):
                        # rank mismatch skips, in both packages
                        t = torch.ones(shape)
                        assert hooks.constrain(t, logical) is t
                        x = jnp.ones(shape)
                        assert jhooks.constrain(x, logical) is x
                        continue
                    want = jhooks.constrain(jnp.ones(shape), logical)
                    assert _pinned(mapping, shape, logical) == want
            for name, dim in (("tensor", 6), ("tensor", 16), ("batch", 8),
                              ("batch", 3), ("kv_heads", 8)):
                got = hooks.axis_for(name, dim)
                ax = mapping[name]
                size = int(np.prod([sizes[a] for a in (
                    ax if isinstance(ax, tuple) else (ax,))])) if ax else 1
                if ax is None or size == 1 or dim % size:
                    assert got is None
                else:
                    assert got.size == size and got.axis == (
                        ax if isinstance(ax, str) or len(ax) > 1 else ax[0])
            x = torch.ones((2, 2, 2))
            assert hooks.constrain(x, ("batch", "tensor")) is x
        assert hooks.current_mesh() is None      # restored on exit
    finally:
        jhooks.clear()


def test_values_unchanged_by_constraints():
    """Configured on a mesh of one rank, the port's model gives the same
    bits as unconfigured (JAX's test holds its configured forward within
    1e-6 of its unconfigured one), within 1e-4 of JAX's forward, and its
    cache splits no kv head over a model axis of one rank."""
    jcfg = JModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                        n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                        vocab=50)
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab=50)
    jparams = jget_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         50)).astype(np.int32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    api = get_model_api(cfg)
    hooks.clear()
    base = api.forward(params, {"tokens": torch.from_numpy(toks)})[0]
    mapping = {"batch": ("data",), "tensor": "model", "sequence": "model",
               "heads": "model", "kv_heads": "model", "expert": None,
               "vocab": "model"}
    with hooks.configured(make_debug_mesh(), mapping):
        out = api.forward(params, {"tokens": torch.from_numpy(toks)})[0]
        state = api.init_decode_state(2, 8, "cpu")
    assert torch.equal(base, out)
    assert tuple(state["caches"]["k"].shape) == (2, 2, 8, 2, 8)
    jbase = np.asarray(jget_model_api(jcfg).forward(
        jparams, {"tokens": jnp.asarray(toks)})[0])
    np.testing.assert_allclose(base.numpy(), jbase, rtol=1e-4, atol=1e-4)
