"""The port's server optimizers against the JAX package's on one nested
parameter tree (dicts with sorted keys, a list of layer dicts, as the
LSTM and the ResNet have) fed the same sequence of directions Δ: the
updates each step, the parameters after ``apply_updates`` and the Adam
family's moments within 1e-6.  Both sides get the same Δ bits, so the
sign flips that rounding in Δ causes in an end-to-end run (see
``test_torch_task_shakespeare_fedadam.py``) cannot arise here: exact
zeros and Δ far below ``eps`` are in the sequence on purpose."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.optim.optimizers import apply_updates as japply_updates
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import apply_updates as tapply_updates
from repro_torch.optim import make_optimizer as tmake_optimizer
from repro_torch.tree import tree_leaves

TOL = 1e-6
STEPS = 6
OPTIMIZERS = [("sgd", dict(lr=1.0)), ("adam", dict(lr=1e-2)),
              ("adamw", dict(lr=1e-2)), ("yogi", dict(lr=1e-2))]


def _tree(rng, scale):
    """{"b": (7,), "layers": [{"w": (5, 8), "b": (8,)}, {"w": (8, 3),
    "b": (3,)}], "emb": (11, 4)}, float32."""
    def leaf(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"b": leaf(7),
            "layers": [{"w": leaf(5, 8), "b": leaf(8)},
                       {"w": leaf(8, 3), "b": leaf(3)}],
            "emb": leaf(11, 4)}


def _directions(seed):
    """STEPS trees of Δ at a pseudo-gradient's scale (1e-2), with some
    coordinates exactly 0 and some within 1e-8 of it."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        tree = _tree(rng, 1e-2)
        for x in jax.tree.leaves(tree):
            flat = x.reshape(-1)
            pick = rng.random(flat.shape)
            flat[pick < 0.1] = 0.0
            tiny = pick > 0.9
            flat[tiny] = (1e-9 * rng.standard_normal(int(tiny.sum()))
                          ).astype(np.float32)
        out.append(tree)
    return out


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[n for n, _ in OPTIMIZERS])
def test_matches_jax_on_nested_tree(name, kw, seed):
    params0 = _tree(np.random.default_rng(100 + seed), 0.5)
    jopt, topt = jmake_optimizer(name, **kw), tmake_optimizer(name, **kw)
    jp = jax.tree.map(jnp.asarray, params0)
    tp = params_from_numpy(params0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step, d in enumerate(_directions(seed)):
        ju, js = jopt.update(jax.tree.map(jnp.asarray, d), js, jp)
        tu, ts = topt.update(params_from_numpy(d, device="cpu"), ts, tp)
        jp, tp = japply_updates(jp, ju), tapply_updates(tp, tu)
        pairs = [("updates", ju, tu), ("params", jp, tp)]
        if name != "sgd":
            pairs += [("m", js.m, ts.m), ("v", js.v, ts.v)]
        for what, want, got in pairs:
            want = [np.asarray(x) for x in jax.tree.leaves(want)]
            got = tree_leaves(params_to_numpy(got))
            assert len(want) == len(got), what
            for i, (w, g) in enumerate(zip(want, got)):
                assert w.shape == g.shape and g.dtype == np.float32
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=TOL,
                    err_msg=f"{what}, leaf {i}, step {step + 1}")
        # the updates are not all rounding: each step moves the tree
        assert max(np.abs(np.asarray(x)).max()
                   for x in jax.tree.leaves(ju)) > 1e-3
