"""Client selection (port of ``repro.core.selection``): the paper's
Alg. 1 line 4 (:func:`f3ast_select`) and Alg. 2
(:func:`fixed_policy_select`), the baselines' draws, the top-K_t cut and
the cohort layout.

Tie-break contract (``(score, id)``): every top-k cut — the argsort path
(:func:`_topk_mask`) and the ``fed_select`` kernel with its plain version
(``repro_torch.kernels``) — resolves equal scores to the LOWER client id,
i.e. ranks by the pair (−score, id).  That is what makes the port's masks
bit-identical to the JAX package's for the same scores.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import random as jr
from .. import xla_math
from .hfun import marginal_utility

# Score sentinel for unavailable clients — low enough that no real score
# reaches it, so unavailable clients rank last.  ``kernels.ref.SELECT_NEG``
# must stay equal to it.
_NEG = -1e30


def _topk_mask(scores: torch.Tensor, avail: torch.Tensor,
               k: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the top-min(k, |avail|) available entries by score.

    A *stable* ascending sort of ``−masked`` gives the ranks with the
    ``(score, id)`` tie-break, exactly as ``jnp.argsort`` does.
    """
    n = scores.shape[0]
    masked = torch.where(avail, scores, torch.full_like(scores, _NEG))
    order = torch.sort(-masked, stable=True).indices
    ranks = torch.empty(n, dtype=torch.int32, device=scores.device)
    ranks[order] = torch.arange(n, dtype=torch.int32, device=scores.device)
    k_eff = torch.minimum(torch.as_tensor(k, device=scores.device)
                          .to(torch.int32), avail.sum().to(torch.int32))
    return (ranks < k_eff) & avail


def f3ast_scores(r: torch.Tensor, p: torch.Tensor,
                 positively_correlated: bool = False,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The utility F3AST ranks by, −∇H(r) (Eq. 4), times (1 + 1e-6·u)
    with u uniform from ``key``: an infinitesimal random tie-break, so
    equal utilities (a uniform r at initialization) do not favour low
    client ids.  Without ``key``, the utility alone."""
    util = marginal_utility(r, p, positively_correlated)
    if key is None:
        return util
    return util * (1.0 + 1e-6 * jr.uniform(key, tuple(util.shape)))


def f3ast_select(avail: torch.Tensor, k, p: torch.Tensor, r: torch.Tensor,
                 positively_correlated: bool = False,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F3AST's greedy selection, S_t ∈ argmax_{S ∈ C_t} −∇H(r)·1_S
    (Algorithm 1 line 4).  H is separable over clients, so the argmax over
    all subsets of at most K_t available clients is exactly the top K_t
    available clients by utility: greedy is optimal.  ``r`` is the
    tracked rate r(t−1); ``key`` adds :func:`f3ast_scores`' tie-break."""
    return _topk_mask(f3ast_scores(r, p, positively_correlated, key),
                      avail, k)


def fixed_policy_select(avail: torch.Tensor, k, p: torch.Tensor,
                        r_target: torch.Tensor,
                        positively_correlated: bool = False) -> torch.Tensor:
    """Fixed-policy F3AST (Algorithm 2): Alg. 1 line 4 with the utility
    at a static target rate ``r_target`` instead of the tracked one."""
    return _topk_mask(marginal_utility(r_target, p, positively_correlated),
                      avail, k)


def fedavg_select(key: torch.Tensor, avail: torch.Tensor, k, p: torch.Tensor,
                  topk: Optional[Callable] = None) -> torch.Tensor:
    """Sample min(k, |avail|) available clients without replacement, with
    probability ∝ p_k (Gumbel top-k: top-k of log p + Gumbel noise).  The
    paper's FedAvg baseline (§4).  Here p is an argument, so the log is
    XLA's runtime ``log``, as a jitted ``fedavg_select`` computes it (the
    ``fedavg`` strategy closes over p, whose log XLA folds).  ``topk``
    swaps the cut (e.g. ``kernels.fed_select.fed_select_mask``)."""
    g = jr.gumbel(key, tuple(p.shape))
    scores = xla_math.log(torch.clamp_min(p, xla_math.f32(1e-12))) + g
    return (topk or _topk_mask)(scores, avail, k)


def uniform_select(key: torch.Tensor, avail: torch.Tensor,
                   k) -> torch.Tensor:
    """Uniform without replacement over the available set: i.i.d. uniform
    scores + top-k is a uniformly random <= k subset of the available."""
    scores = jr.uniform(key, tuple(avail.shape))
    return _topk_mask(scores, avail, k)


def poc_select(key: torch.Tensor, avail: torch.Tensor, m, p: torch.Tensor,
               losses: torch.Tensor, d: int,
               topk: Optional[Callable] = None) -> torch.Tensor:
    """Power-of-Choice (Cho et al., the paper's loss-based baseline): d
    candidates sampled ∝ p_k from the available pool
    (:func:`fedavg_select`), then the top-m candidates by current loss.
    ``topk`` routes both cuts, the candidate draw and the loss cut."""
    cut = topk or _topk_mask
    cand = fedavg_select(key, avail, int(d), p, topk=cut)
    return cut(losses, cand, m)


def cohort_ids_from_mask(mask: torch.Tensor, cohort_size: int):
    """Selection mask (N,) bool → padded cohort (ids (K,) int64, valid (K,)).

    Selected ids in ascending order, slots past |S| repeating the first
    selected client with ``valid=False`` — the JAX package's layout.
    """
    n = mask.shape[0]
    ids_all = torch.arange(n, dtype=torch.int64, device=mask.device)
    ranked = torch.sort(torch.where(mask, ids_all,
                                    torch.full_like(ids_all, n))).values
    ids = ranked[:cohort_size]
    valid = ids < n
    first = torch.clamp_max(ranked[0], n - 1)   # the mask is never empty
    return torch.where(valid, ids, first), valid


# ---------------------------------------------------------------------------
# The distributed cut of the client-sharded engine
# ---------------------------------------------------------------------------

TOPK_IMPLS = ("stream", "allgather")
_M32 = 0xFFFFFFFF


def _desc_keys(vals: torch.Tensor, gids: torch.Tensor) -> torch.Tensor:
    """int64 keys whose ascending order is the (−score, gid) order: the
    high 32 bits are −score as an order-preserving signed word (−0.0 taken
    as +0.0, as the cut's comparisons do), the low 32 bits the gid.  One
    key a candidate is what the shards exchange: its 8 bytes are the
    (f32 score, i32 gid) pair of the JAX package's wire format."""
    neg = -vals
    neg = torch.where(neg == 0, torch.zeros_like(neg), neg)
    i = neg.view(torch.int32)
    i = torch.where(i < 0, i ^ 0x7FFFFFFF, i).to(torch.int64)
    return (i << 32) | gids.to(torch.int64)


def _merge_keys(a: torch.Tensor, b: torch.Tensor, keep: int) -> torch.Tensor:
    """The first ``keep`` of the sorted union of two sorted key lists:
    top-k(A ∪ B) = top-k(top-k(A) ∪ top-k(B)), since gids are unique and
    the key order is strict."""
    return torch.sort(torch.cat([a, b])).values[:keep]


def _stream_reduce(keys: torch.Tensor, axis, keep_max: int) -> torch.Tensor:
    """Reduce each shard's sorted list to the replicated global first
    ``min(keep_max, total)`` over ``ppermute`` exchanges, no full gather.
    Power-of-2 shard counts run a butterfly (log2(D) stages, partner
    ``i XOR 2^s``, the list capped at ``keep_max``); other counts a ring
    (D−1 single-neighbour steps).  Every shard ends with the same list,
    in the order the all-gather + global sort gives."""
    d, i = axis.size, axis.rank
    kk = keys.shape[0]
    if d == 1:
        return keys
    if d & (d - 1) == 0:                      # butterfly: log2(D) stages
        length = kk
        for s in range(d.bit_length() - 1):
            partner = i ^ (1 << s)
            other = axis.exchange(keys, partner, partner)
            length = min(int(keep_max), 2 * length)
            keys = _merge_keys(keys, other, length)
        return keys
    buf = keys                                # ring: pass a buffer around
    for step in range(1, d):
        buf = axis.exchange(buf, (i + 1) % d, (i - 1) % d)
        keys = _merge_keys(keys, buf, min(int(keep_max), kk * (step + 1)))
    return keys


def _compact(mask: torch.Tensor, count: int, fill: int) -> torch.Tensor:
    """Ascending indices of the set entries of ``mask``, the first
    ``count`` of them, padded with ``fill`` — in O(len) with no host sync
    (a cumulative sum scatters each set index to its rank)."""
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < count), pos, count)
    out = torch.full((count + 1,), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def _block_candidates(masked: torch.Tensor, avail: torch.Tensor, kk: int,
                      off: int, n_fill: int) -> torch.Tensor:
    """This shard's top-``kk`` of ``masked`` as sorted keys, lower id
    first on ties.  On the CPU the stable sort of ``_topk_mask`` (what
    ``lax.top_k`` keeps); on CUDA the ``fed_select_mask`` kernel cuts the
    block's top-``kk`` available clients, which are then compacted and
    ordered, and the list is filled with (−1e30, gid >= ``n_fill``)
    entries where the block has fewer than ``kk`` available — entries a
    global cut never takes (it takes at most |available| candidates),
    where ``lax.top_k`` would list unavailable clients at −1e30."""
    dev = masked.device
    if dev.type == "cpu":
        order = torch.sort(-masked, stable=True).indices[:kk]
        return torch.sort(_desc_keys(masked[order], order + off)).values
    from ..kernels.fed_select import fed_select_mask
    cut = fed_select_mask(masked, avail, kk)
    loc = _compact(cut, kk, -1)
    real = loc >= 0
    vals = torch.where(real, masked[torch.clamp_min(loc, 0)],
                       torch.full_like(masked[:1], _NEG))
    gids = torch.where(real, loc + off,
                       n_fill + torch.arange(kk, device=dev))
    return torch.sort(_desc_keys(vals, gids)).values


def sharded_topk_mask(scores: torch.Tensor, avail: torch.Tensor, k,
                      axis, k_max: int,
                      method: str = "allgather") -> torch.Tensor:
    """Distributed :func:`_topk_mask` for one shard of the client mesh
    ``axis`` (a ``launch.mesh.ClientMesh``).

    ``scores``/``avail`` are this shard's block.  Each shard's
    top-``min(k_max, n_local)`` candidates are reduced to the global list
    and cut at ``k_eff = min(k, |avail|)`` in (−score, global id) order —
    the stable argsort's tie-break.  A client the global cut takes is
    among its own shard's top k_max, so the candidate cut loses nothing.
    Returns this shard's (n_local,) mask block, bitwise ``_topk_mask`` on
    the full arrays.  ``method``: ``"allgather"`` gathers every shard's
    list and sorts it; ``"stream"`` merges the lists pairwise over
    ``ppermute`` steps (:func:`_stream_reduce`).
    """
    if method not in TOPK_IMPLS:
        raise ValueError(f"unknown sharded top-k method {method!r}; "
                         f"known: {TOPK_IMPLS}")
    n_local = scores.shape[0]
    dev = scores.device
    off = axis.rank * n_local
    masked = torch.where(avail, scores, torch.full_like(scores, _NEG))
    kk = min(int(k_max), n_local)
    keys = _block_candidates(masked, avail, kk, off, axis.size * n_local)
    n_avail = axis.all_reduce(avail.sum().to(torch.int64).reshape(1))[0]
    k_eff = torch.minimum(torch.as_tensor(k, device=dev).to(torch.int64),
                          n_avail)
    if method == "stream":
        top = _stream_reduce(keys, axis, k_max)
    else:
        top = torch.sort(axis.all_gather(keys)).values
    take = torch.arange(top.shape[0], device=dev) < k_eff
    loc = (top & _M32) - off
    hit = take & (loc >= 0) & (loc < n_local)
    out = torch.zeros(n_local + 1, dtype=torch.bool, device=dev)
    out[torch.where(hit, loc, n_local)] = hit
    return out[:n_local] & avail


def sharded_cohort_ids_from_mask(mask: torch.Tensor, cohort_size: int,
                                 axis, n_total: int,
                                 method: str = "allgather"):
    """Distributed :func:`cohort_ids_from_mask` for one shard of the mesh
    ``axis``: each shard contributes its lowest selected ids (at most
    ``min(cohort_size, n_local)`` of them), reduced to the global lowest
    ``cohort_size`` by ``all_gather`` + sort or, with ``method="stream"``,
    by the ``ppermute`` schedule of :func:`sharded_topk_mask`.
    ``n_total`` is the real N — the single-device path's sentinel — so
    (ids, valid) are bitwise ``cohort_ids_from_mask`` on the full mask,
    and the same on every shard.  The ids travel as int32."""
    if method not in TOPK_IMPLS:
        raise ValueError(f"unknown sharded top-k method {method!r}; "
                         f"known: {TOPK_IMPLS}")
    n_local = mask.shape[0]
    off = axis.rank * n_local
    kk = min(int(cohort_size), n_local)
    loc = _compact(mask, kk, -1)
    mine = torch.where(loc >= 0, loc + off,
                       torch.full_like(loc, n_total)).to(torch.int32)
    if method == "stream":
        cand = _stream_reduce(mine, axis, cohort_size)
        pad = cohort_size - cand.shape[0]
        if pad > 0:          # the streamed list may be < cohort_size
            cand = torch.cat([cand, torch.full((pad,), n_total,
                                               dtype=cand.dtype,
                                               device=cand.device)])
    else:
        cand = torch.sort(axis.all_gather(mine)).values
    cand = cand.to(torch.int64)
    ids = cand[:cohort_size]
    valid = ids < n_total
    first = torch.clamp_max(cand[0], n_total - 1)
    return torch.where(valid, ids, first), valid
