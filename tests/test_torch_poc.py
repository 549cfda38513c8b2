"""Power-of-Choice in the port: ``poc_select`` and the strategy's
``select`` bitwise JAX's on the same losses (ties included), and the
end-to-end rule for a strategy whose inputs are model outputs.

PoC's losses are float32 means over 64 samples, which the two packages
(and the card and the CPU) sum in different orders; so a run's mask is
bitwise only while the loss cut is not a near-tie.  Over 25 rounds the
fresh losses each loop passes to ``select`` must agree within 1e-5
relative, and the masks bitwise in every round whose cut margin (the gap
between the K_t-th and (K_t+1)-th candidate losses) exceeds the two
packages' loss difference over the candidates, or where each package
ranks the same candidates above the K_t-th loss and ties the same ones
with it (round 0: the zero-initialised softmax regression gives every
client log 10 in each package, one ulp apart between them, a tie the
(loss, id) order cuts alike); a round under its margin would end the
comparison and be reported with it.  What the loops pass in is
recorded through a wrapper of ``make_strategy``, not a result field."""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.sim as jsim
import repro.sim.runner as jrunner
import repro_torch.sim as tsim
import repro_torch.sim.runner as trunner
from repro.core import selection as jsel
from repro.core import strategies as jstrat
from repro_torch import random as tr
from repro_torch.core import selection as tsel
from repro_torch.core import strategies as tstrat
from torch_parity import one_intra_op_thread

ROUNDS = 25
LOSS_RTOL = 1e-5


def _quiet(*args, **kwargs):
    pass


def _case(seed, n=200, ties=False):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(n, 0.5)).astype(np.float32)
    avail = rng.random(n) < 0.5
    losses = rng.random(n).astype(np.float32)
    if ties:       # a handful of distinct values: most candidates tie
        losses = np.round(losses * 3).astype(np.float32) / 3
    return p, avail, losses


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ties", [False, True])
def test_poc_select_bitwise_jax(seed, ties):
    """Against JAX's eager ``poc_select`` (its host loop's) and its jitted
    one with ``p`` an argument: both cuts with the (loss, id) tie-break."""
    p, avail, losses = _case(seed, ties=ties)
    jp, ja, jl = jnp.asarray(p), jnp.asarray(avail), jnp.asarray(losses)
    tp, ta, tl = (torch.from_numpy(x) for x in (p, avail, losses))
    jit = jax.jit(jsel.poc_select, static_argnames=("d",))
    for i, (m, d) in enumerate(((5, 30), (10, 30), (1, 3), (40, 30))):
        jkey = jax.random.PRNGKey(100 * seed + i)
        tkey = tr.PRNGKey(100 * seed + i, device="cpu")
        got = tsel.poc_select(tkey, ta, m, tp, tl, d).numpy()
        eager = np.asarray(jsel.poc_select(jkey, ja, jnp.asarray(m), jp, jl,
                                           d))
        jitted = np.asarray(jit(jkey, ja, jnp.asarray(m), jp, jl, d=d))
        assert got.tobytes() == eager.tobytes() == jitted.tobytes(), (m, d)
        assert got.sum() == min(m, d, avail.sum())
        # the plain version of the kernel's mask-only mode cuts the same
        from repro_torch.kernels.fed_select import fed_select_mask
        via_kernel = tsel.poc_select(tkey, ta, m, tp, tl, d,
                                     topk=fed_select_mask).numpy()
        assert via_kernel.tobytes() == got.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_poc_strategy_select_bitwise_jax(seed):
    """The strategy's select on the same losses: mask and weights bitwise
    JAX's (eager, as its host loop calls it); r_k within 1e-6 (JAX's eager
    EMA rounds twice where the port's fuses); K_t as a device int32."""
    p, avail, losses = _case(seed, n=100, ties=seed == 1)
    js = jstrat.make_strategy("poc", 100, p, clients_per_round=10)
    ts = tstrat.make_strategy("poc", 100, p, device="cpu",
                              clients_per_round=10)
    jstate, tstate = js.init(100), ts.init(100)
    for t in range(4):
        jkey = jax.random.PRNGKey(seed * 10 + t)
        tkey = tr.PRNGKey(seed * 10 + t, device="cpu")
        k_t = 10 - 2 * t
        jm, jw, jstate = js.select(
            jstate, jkey, jnp.asarray(avail), jnp.asarray(k_t, jnp.int32),
            jstrat.SelectCtx(t=t, losses=jnp.asarray(losses)))
        tm, tw, tstate = ts.select(
            tstate, tkey, torch.from_numpy(avail),
            torch.tensor(k_t, dtype=torch.int32),
            tstrat.SelectCtx(t=t, losses=torch.from_numpy(losses)))
        assert tm.numpy().tobytes() == np.asarray(jm).tobytes()
        assert tw.numpy().tobytes() == np.asarray(jw).tobytes()
        np.testing.assert_allclose(tstate.rates.r.numpy(),
                                   np.asarray(jstate.rates.r), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="ctx.losses"):
        ts.select(tstate, tkey, torch.from_numpy(avail), 3,
                  tstrat.SelectCtx(t=0))


def _cut_sets(losses, cand, k):
    """(clients above the K-th candidate loss, clients tied with it)."""
    ids = np.flatnonzero(cand)
    kth = np.sort(losses[ids])[::-1][min(k, len(ids)) - 1]
    return (set(ids[losses[ids] > kth].tolist()),
            set(ids[losses[ids] == kth].tolist()))


def _recording(monkeypatch, module, log):
    """Wrap ``module.make_strategy`` so each select call appends what the
    loop passed in: (key, avail, k_t, losses) as numpy."""
    real = module.make_strategy

    def make(*args, **kwargs):
        s = real(*args, **kwargs)

        def select(state, key, avail, k_t, ctx=None):
            log.append(tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                             for x in (key, avail, k_t, ctx.losses)))
            return s.select(state, key, avail, k_t, ctx)
        return s._replace(select=select)
    monkeypatch.setattr(module, "make_strategy", make)


@pytest.mark.parametrize("seed", [0, 1])
def test_poc_runs_hold_the_margin_rule(seed, monkeypatch):
    jlog, tlog = [], []
    _recording(monkeypatch, jrunner, jlog)
    _recording(monkeypatch, trunner, tlog)
    spec = jsim.RunSpec(strategy="poc", engine="host", rounds=ROUNDS,
                        seed=seed, eval_every=ROUNDS)
    with one_intra_op_thread(), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jres = jsim.run_spec(spec, log_fn=_quiet)
        tres = tsim.run_spec(tsim.RunSpec.from_json(spec.to_json()),
                             device="cpu", log_fn=_quiet)
    assert len(jlog) == len(tlog) == ROUNDS
    p = torch.from_numpy(trunner.build_task("synthetic11", seed,
                                            device="cpu")[1].p)
    compared, under = 0, []
    for t, (j, tt) in enumerate(zip(jlog, tlog)):
        assert j[0].tolist() == tt[0].tolist()            # the select key
        assert j[1].tobytes() == tt[1].tobytes()          # avail
        assert int(j[2]) == int(tt[2])                    # K_t
        diff = float(np.max(np.abs(tt[3] - j[3]) / np.abs(j[3])))
        assert diff <= LOSS_RTOL, (t, diff)
        # the cut margin among this round's d = 30 candidates
        cand = tsel.fedavg_select(torch.from_numpy(tt[0]),
                                  torch.from_numpy(tt[1]), 30, p).numpy()
        cl = np.sort(tt[3][cand])[::-1]
        k = int(tt[2])
        margin = float(cl[k - 1] - cl[k]) if len(cl) > k else np.inf
        gap = float(np.max(np.abs(tt[3][cand] - j[3][cand])))
        # the cut clears the two packages' difference, or each package
        # ranks the same clients above the K_t-th loss and ties the same
        # ones with it (the id order then cuts the tie alike)
        if margin <= gap and _cut_sets(tt[3], cand, k) != _cut_sets(
                j[3], cand, k):
            under.append((t, margin, gap))
            break
        assert tres.sel_history[t].tobytes() == jres.sel_history[t].tobytes()
        compared += 1
    print(f"seed {seed}: {compared} rounds compared bitwise; rounds under "
          f"their margin: {under}")
    assert compared + len(under) >= 1
    assert compared == ROUNDS, f"a near-tie cut ended the comparison: {under}"
