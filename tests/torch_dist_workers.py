"""Rank functions of the port's client-mesh tests, run in processes spawned
by ``repro_torch.launch.mesh.spawn_ranks``.  Each takes the rank's
``ClientMesh`` and numpy inputs and returns numpy outputs; this module
imports torch and the port only, so a spawned rank starts fast."""
import numpy as np
import torch

from repro_torch import random as tr
from repro_torch.core import bitmask, selection
from repro_torch.core.availability import force_nonempty_block
from repro_torch.core.blockrng import block_uniform
from repro_torch.sim.processes import make_process


def _block(x: np.ndarray, mesh) -> torch.Tensor:
    nl = x.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.rank * nl:(mesh.rank + 1) * nl]))


def gather_bits(mesh, masks, ns):
    """``all_gather_bits`` of each padded mask's block, and the bool gather
    of the same block."""
    return [(bitmask.all_gather_bits(_block(m, mesh), mesh, n).numpy(),
             mesh.all_gather(_block(m, mesh))[:n].numpy())
            for m, n in zip(masks, ns)]


def topk_cases(mesh, cases, k_max, cohort):
    """``sharded_topk_mask`` (both methods) and
    ``sharded_cohort_ids_from_mask`` (both methods) of each (scores,
    avail, k, mask) case's blocks; the masks reassembled by a gather."""
    out = []
    for scores, avail, k, mask in cases:
        row = {}
        for method in selection.TOPK_IMPLS:
            m = selection.sharded_topk_mask(
                _block(scores, mesh), _block(avail, mesh),
                torch.tensor(k, dtype=torch.int32), mesh, k_max,
                method=method)
            row[f"topk_{method}"] = mesh.all_gather(m).numpy()
            ids, valid = selection.sharded_cohort_ids_from_mask(
                _block(mask, mesh), cohort, mesh, mask.shape[0],
                method=method)
            row[f"ids_{method}"] = (ids.numpy(), valid.numpy())
        out.append(row)
    return out


def nonempty_cases(mesh, seed, cases, q_lin):
    """``Bernoulli.step_block`` of each (n, q, sigma) case, and
    ``force_nonempty_block`` of an all-down mask over the marginals
    ``q_lin`` (64 a shard); the blocks reassembled by a gather."""
    out = []
    key = tr.PRNGKey(seed, device="cpu")
    for n, q, sigma in cases:
        quantum = mesh.size * 32
        nl = -(-n // quantum) * quantum // mesh.size
        model = make_process("bernoulli", n, q=q, sigma=sigma, device="cpu")
        _, blk = model.step_block(key, (), 0, off=mesh.rank * nl,
                                  n_local=nl, axis=mesh)
        out.append(mesh.all_gather(blk).numpy())
    q = torch.from_numpy(q_lin)
    n = q.shape[0]
    nl = n // mesh.size
    off = mesh.rank * nl
    tie = block_uniform(tr.fold_in(key, 1), n, off, nl)
    q_blk = q[off:off + nl]
    cand = torch.where(q_blk >= q.max(), tie, -1.0)
    got = force_nonempty_block(torch.zeros(nl, dtype=torch.bool), cand, off,
                               mesh)
    out.append(mesh.all_gather(got).numpy())
    return out


def run_specs(mesh, spec_jsons, chunk_sizes=None):
    """``run_spec``'s rank body (``runner._run_device`` with this mesh) for
    each spec: rank 0 returns the results' streams and final r_k."""
    from repro_torch.sim import RunSpec
    from repro_torch.sim.runner import _run_device
    out = []
    for i, js in enumerate(spec_jsons):
        rs = RunSpec.from_json(js).resolved()
        if chunk_sizes is not None:
            rs = rs.replace(chunk_size=chunk_sizes[i])
        res = _run_device(rs, rs.strategy, torch.device("cpu"),
                          lambda *a: None, mesh)
        out.append(dict(sel=res.sel_history, comp=res.comp_history,
                        k_t=res.k_t, n_available=res.n_available,
                        rates=res.rates, train_loss=res.train_loss,
                        delta_norm=res.delta_norm,
                        final=res.final_metrics))
    return out if mesh.rank == 0 else None


def engine_parts(n: int, k: int = 10, device="cpu") -> dict:
    """The parts of the JAX package's N-scaling cell
    (``benchmarks/bench_engine.py::_build_nscale_engine``): bernoulli
    q = 0.3, constant K = k, f3ast with p = 1/N, softmax regression (dim
    32, 10 classes), server sgd lr 1.0, client lr 0.05, E = 5, B = 20;
    ``loss`` in place of the round, which the caller builds."""
    import functools
    from repro_torch.core.strategies import make_strategy
    from repro_torch.models import softmax_reg
    from repro_torch.optim import make_optimizer
    from repro_torch.sim.budgets import make_budget
    cfg = softmax_reg.SoftmaxRegConfig(dim=32, n_classes=10)
    return dict(
        avail_model=make_process("bernoulli", n, q=0.3, device=device),
        budget=make_budget("constant", k=k, device=device),
        strategy=make_strategy("f3ast", n, np.full(n, 1.0 / n, np.float32),
                               clients_per_round=k, device=device),
        init_params=functools.partial(softmax_reg.init_params, cfg,
                                      device=device),
        opt=make_optimizer("sgd", lr=1.0), client_lr=0.05, local_steps=5,
        local_batch=20, loss=functools.partial(softmax_reg.loss_fn, cfg))


def synth_engines(mesh, n, rounds, k, topk_impl, seed):
    """The sharded engine on a ``SynthTask`` of n clients
    (:func:`engine_parts`): its unpacked streams and final r_k from rank
    0."""
    from repro_torch.core.fedstep import make_fed_round
    from repro_torch.data import SynthTask
    from repro_torch.sim.engine import _to_host
    from repro_torch.sim.engine_sharded import ShardedEngine
    parts = engine_parts(n, k)
    parts["fed_round"] = make_fed_round(
        parts.pop("loss"), parts["opt"], cohort_axis=mesh, cohort_slots=k)
    eng = ShardedEngine(mesh=mesh, staged=SynthTask(n_clients=n, seed=seed),
                        n_clients=n, topk_impl=topk_impl, device="cpu",
                        **parts)
    carry = eng.init_carry(tr.PRNGKey(0, device="cpu"))
    carry, out = eng.chunk(carry, range(rounds))
    host = _to_host(out, n)
    return (dict(host._asdict(), rates=carry.algo_state.rates.r.numpy(),
                 comm=eng.selection_comm_bytes_per_round,
                 staged=eng.n_staged_bytes)
            if mesh.rank == 0 else None)


def _result_np(res) -> dict:
    """A run's streams, final r_k, final metrics and whole final
    parameters (numpy)."""
    return dict(sel=res.sel_history, comp=res.comp_history, k_t=res.k_t,
                n_available=res.n_available, rates=res.rates,
                train_loss=res.train_loss, delta_norm=res.delta_norm,
                final=res.final_metrics, params=res.final_params)


def model_axis_runs(mesh, runs, blocks=None):
    """``run_spec`` inside this group, as under torchrun, for each (spec
    JSON, mesh shape) of ``runs``, the shape put into the spec's
    ``mesh_shape`` (``run_spec`` builds the mesh over the spec's axis
    names): rank 0 returns the results in order, the others None.  With
    ``blocks`` = (spec JSON, shapes) every rank also returns, for that
    spec on each shape, the element count and the storage's element count
    of each leaf its engine's ``init_carry`` keeps (parameters, then the
    server optimizer's state), and the (2, 2) mesh's clients-axis
    ``exchange`` of its global rank."""
    from repro_torch.launch.mesh import make_fed_mesh
    from repro_torch.sim import RunSpec, run_spec
    from repro_torch.sim.engine import build_engine
    from repro_torch.tree import tree_leaves
    out = {"runs": [], "blocks": {}, "exchange": None}
    for js, shape in runs:
        res = run_spec(RunSpec.from_json(js).replace(mesh_shape=tuple(shape)),
                       device="cpu", log_fn=lambda *a: None)
        out["runs"].append(_result_np(res) if mesh.rank == 0 else None)
    js, shapes = blocks if blocks is not None else (None, ())
    for shape in shapes:
        fmesh = make_fed_mesh(shape)
        rs = RunSpec.from_json(js).resolved()
        engine, _ = build_engine(rs.scenario, rs.strategy, device="cpu",
                                 server_opt=rs.server_opt,
                                 server_lr=rs.server_lr, mesh=fmesh)
        carry = engine.init_carry(tr.PRNGKey(0, device="cpu"))
        out["blocks"][shape] = [
            (x.numel(), x.untyped_storage().nbytes() // x.element_size())
            for x in tree_leaves((carry.params, carry.opt_state))
            if torch.is_tensor(x)]
        if shape == (2, 2):
            c = fmesh.axis_mesh("clients")
            got = c.exchange(torch.tensor([fmesh.rank]), (c.rank + 1) % 2,
                             (c.rank + 1) % 2)
            out["exchange"] = int(got)
    return out


def _smoke_arch(arch_id: str):
    import dataclasses
    from repro_torch.configs import get_arch
    spec = get_arch(arch_id)
    return dataclasses.replace(spec, model=spec.smoke_model)


def local_shapes(shapes, specs, mesh):
    """A rank's shapes of the global ``shapes`` (a tree of
    ``launch.specs.ShapeDtype``) laid out by ``specs`` over ``mesh``:
    each dim whose entry names axes divided by their ranks together."""
    from repro_torch.launch.specs import ShapeDtype, is_shape
    from repro_torch.sharding.rules import specs_up_to
    from repro_torch.tree import tree_leaves_with_path, tree_unflatten

    def one(s, spec):
        shape = list(s.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                shape[d] //= mesh.axes_mesh(entry).size
        return ShapeDtype(tuple(shape), s.dtype)

    leaves = [x for _, x in tree_leaves_with_path(shapes, is_shape)]
    return tree_unflatten(shapes, [one(s, spec) for s, spec in zip(
        leaves, specs_up_to(shapes, specs))], is_shape)


def mesh_serve(mesh, cases):
    """The serving programs over a (data, model) mesh on each case (an
    arch's smoke config, the full parameters and the inputs in numpy):
    ``build_prefill_step(arch, "prefill_32k", mesh)`` on ``tokens``
    (its blocks carved by ``MeshStep.shard``), then
    ``build_decode_step(arch, "decode_32k", mesh)`` from a zero state,
    teacher-forced over ``prompt`` and greedy (``MeshStep.greedy``, the
    rank's rows fed back) for ``greedy`` more steps.  Every rank returns
    the gathered logits and tokens, its blocks' shapes against the
    step's specs (:func:`local_shapes`), its stored parameter elements,
    and whether the
    hooks were left configured."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.specs import ShapeDtype
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.sharding import hooks
    from repro_torch.sharding.rules import gather_full, local_blocks
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    out = []
    for c in cases:
        arch = _smoke_arch(c["arch"])
        params = params_from_numpy(c["params"], device="cpu")
        tokens = torch.from_numpy(c["tokens"])
        B = tokens.shape[0]
        pre = build_prefill_step(arch, "prefill_32k", mesh)
        p_loc, b_loc = pre.shard((params, {"tokens": tokens}), B)
        local = [tuple(x.shape) for x in tree_leaves(p_loc)]
        want = [tuple(s.shape) for _, s in tree_leaves_with_path(
            local_shapes(pre.args[0], pre.in_specs[0], mesh),
            lambda x: isinstance(x, ShapeDtype))]
        logits = pre.gather(pre.fn(p_loc, b_loc), B)
        dec = build_decode_step(arch, "decode_32k", mesh)
        (_, _, tok_spec), _ = dec.specs(B)
        state = dec.init_state(B, c["max_len"], "cpu")
        prompt = torch.from_numpy(c["prompt"])
        steps, toks = [], []
        tok = local_blocks(prompt[:, :1], tok_spec, mesh)
        n = prompt.shape[1] + c["greedy"]
        for t in range(n):
            lg, state = dec.fn(p_loc, state, tok)
            steps.append(dec.gather(lg, B).numpy())
            g = dec.greedy(lg)
            toks.append(gather_full(g, tok_spec, mesh).numpy())
            tok = (local_blocks(prompt[:, t + 1:t + 2], tok_spec, mesh)
                   if t + 1 < prompt.shape[1] else g)
        cache = state["caches"]["k"]
        out.append(dict(prefill=logits.numpy(), decode=np.stack(steps),
                        greedy=np.concatenate(toks, axis=1),
                        local_shapes=local, want_shapes=want,
                        cache_shape=tuple(cache.shape),
                        state_index=int(state["index"]),
                        stored=sum(x.numel() for x in tree_leaves(p_loc)),
                        hooks_left=hooks.current_mesh() is not None,
                        mapping=dec.mapping))
    return out


def mesh_serve_pod(world, shape, cases):
    """:func:`mesh_serve` over a (pod, data, model) mesh of ``shape``
    built over the spawned group (``world``, its 1-D mesh); every rank
    also returns its index over (pod, data) together."""
    from repro_torch.launch.mesh import _grid_mesh
    mesh = _grid_mesh(tuple(shape), ("pod", "data", "model"))
    return [dict(run, data_index=mesh.axes_mesh(("pod", "data")).rank)
            for run in mesh_serve(mesh, cases)]
