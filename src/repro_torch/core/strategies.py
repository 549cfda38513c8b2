"""Pluggable client-selection strategies: protocol + string registry.

Port of ``repro.core.strategies``.  A strategy is a pair of pure functions
on tensors:

    init(n_clients, r0=None) -> state
    select(state, key, avail, k_t, ctx) -> (mask, weights, new_state)

``mask``/``weights`` are full (N,) tensors (weights zero off-cohort).
Strategies built with :func:`topk_strategy` are "score the available
clients, keep the top K_t, weight the winners".

Where the cut runs (``select_impl``):

* on CUDA, both ``"xla"`` and ``"pallas"`` run the ``fed_select`` CUDA
  kernel (fused cut + EMA + weights; the cut alone when a completion hook
  splits it from ``finalize``) — the two spellings are bit-identical by
  contract, so the card has one path;
* on the CPU, ``"xla"`` runs the unfused chain (stable-argsort cut →
  ``update_rates`` → weight rule) and ``"pallas"`` the fused plain version
  of the kernel.

Registry (the paper's policy and its baselines):

  f3ast            greedy −∇H(r) top-K (Alg. 1)     weights p_k/r_k (unbiased)
  fixed_f3ast      Alg. 2, frozen target rate        weights p_k/r_k(target)
  fedavg           sample ∝ p_k over available       weights 1/|S|  (biased)
  fedavg_weighted  sample ∝ p_k over available       weights ∝ p_k  (biased)
  uniform          uniform over available            weights 1/|S|  (biased)

  poc              Power-of-Choice (host-only: needs fresh per-client losses)

and the alias ``fedadam`` (fedavg with a server Adam step).  The registry
flags ``needs_losses``/``host_only`` route a strategy to the host loop, as
in the JAX package.  :func:`as_sharded` wraps a strategy's ``score`` and
``finalize`` around the distributed cut of the client-sharded engine
(``f3ast`` and ``fixed_f3ast`` also score a shard's block alone, through
``score_block``).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import selection as sel
from .bitmask import all_gather_bits
from .blockrng import block_uniform
from .aggregation import fedavg_weights, unbiased_weights, uniform_weights
from .hfun import R_MIN, marginal_utility
from .rates import RateState, init_rates, update_rates
from .. import random as jr
from ..device import resolve_device
from ..sharding.rules import pad_client_dim

__all__ = [
    "SELECT_IMPLS", "STRATEGY_ALIASES", "STRATEGY_REGISTRY",
    "RateTrackState", "SelectCtx", "SelectionStrategy", "StrategyAlias",
    "apply_completion", "as_sharded", "get_strategy_entry",
    "list_strategies", "make_strategy", "register_strategy",
    "resolve_strategy", "strategy_rates", "topk_strategy",
]

SELECT_IMPLS = ("xla", "pallas")


def _check_select_impl(select_impl: str) -> str:
    if select_impl not in SELECT_IMPLS:
        raise ValueError(f"unknown select_impl {select_impl!r}; "
                         f"known: {SELECT_IMPLS}")
    return select_impl


def _topk_fn(select_impl: str, cuda: bool) -> Callable:
    """The (scores, avail, k) -> mask cut — bit-identical either way."""
    if cuda or select_impl == "pallas":
        from ..kernels.fed_select import fed_select_mask
        return fed_select_mask
    return sel._topk_mask


class SelectCtx(NamedTuple):
    """Per-round side inputs a strategy may consume (all optional).
    ``complete`` is the engine's completion hook, ``(N,) selection mask ->
    (N,) completed mask``; None means selected == completed.  ``losses``
    (fresh per-client losses) is read by the host-only strategies."""
    t: Optional[Any] = None
    losses: Optional[torch.Tensor] = None
    complete: Optional[Callable] = None


def apply_completion(ctx: Optional[SelectCtx],
                     mask: torch.Tensor) -> torch.Tensor:
    """Completed mask from the engine's completion hook (identity without)."""
    if ctx is None or ctx.complete is None:
        return mask
    return ctx.complete(mask)


class RateTrackState(NamedTuple):
    """State of the built-in strategies: the Alg. 1 line-5 rate EMA."""
    rates: RateState


class SelectionStrategy(NamedTuple):
    """A selection policy as pure functions; ``rates_of(state)`` reads a
    tracked (N,) participation rate from a state of its own layout (for
    reporting; None: the built-in ``state.rates.r``);
    ``needs_losses``/``host_only`` route it to the host loop
    (``needs_losses``: fresh per-client losses in ``ctx.losses`` each
    round).

    ``score_block(state, key, avail_blk, k_t, ctx, off, n_total) ->
    (n_local,) f32`` is the optional blockwise spelling of ``score`` for
    the sharded engine: the slice ``[off, off + n_local)`` of the
    full-width scores, bitwise, with pad lanes 0."""
    name: str
    init: Callable[..., Any]
    select: Callable[..., Any]
    score: Optional[Callable[..., Any]] = None
    finalize: Optional[Callable[..., Any]] = None
    rates_of: Optional[Callable[[Any], Any]] = None
    n_clients: Optional[int] = None
    needs_losses: bool = False
    host_only: bool = False
    score_block: Optional[Callable[..., Any]] = None


def strategy_rates(strategy: SelectionStrategy, state):
    """Tracked (N,) participation rates of ``state``, or None: through
    ``strategy.rates_of`` when it is set, else the built-in state
    convention ``state.rates.r``."""
    if strategy.rates_of is not None:
        return strategy.rates_of(state)
    return getattr(getattr(state, "rates", None), "r", None)


def topk_strategy(name: str, init: Callable, score: Callable,
                  finalize: Callable, *, n_clients: Optional[int] = None,
                  rates_of: Optional[Callable] = None,
                  select_impl: str = "xla",
                  fused: Optional[Callable] = None,
                  score_block: Optional[Callable] = None,
                  device=None) -> SelectionStrategy:
    """Build a strategy from the canonical score → top-k → weight shape
    for ``device`` (None: CUDA), which picks the cut.

    ``fused(state, scores, avail, k_t) -> (mask, weights, new_state)`` is
    the one-call spelling of cut + ``finalize``: used on CUDA, and on the
    CPU under ``select_impl="pallas"``, whenever no completion hook splits
    the cut from ``finalize``.  ``rates_of`` is passed on to the
    strategy (:func:`strategy_rates`).
    """
    _check_select_impl(select_impl)
    cuda = resolve_device(device).type == "cuda"
    topk = _topk_fn(select_impl, cuda)
    use_fused = fused is not None and (cuda or select_impl == "pallas")

    def select(state, key, avail, k_t, ctx: Optional[SelectCtx] = None):
        scores = score(state, key, avail, k_t, ctx)
        if use_fused and (ctx is None or ctx.complete is None):
            return fused(state, scores, avail, k_t)
        mask = topk(scores, avail, k_t)
        completed = apply_completion(ctx, mask)
        weights, new_state = finalize(state, completed, ctx)
        return mask, weights, new_state

    return SelectionStrategy(name=name, init=init, select=select,
                             score=score, finalize=finalize,
                             rates_of=rates_of, n_clients=n_clients,
                             score_block=score_block)


def _fused_rate_select(p: torch.Tensor, beta: float, weight_mode: str,
                       r_weight_of: Optional[Callable] = None) -> Callable:
    """One ``kernels.fed_select`` call yields the mask, the Alg. 1 line-5
    rate EMA and the line-9 weights — bit-identical to the unfused chain.
    ``r_weight_of(state)`` supplies the frozen rate of
    ``weight_mode="unbiased_frozen"`` (Alg. 2)."""
    from ..kernels.fed_select import fed_select

    def fused(state, scores, avail, k_t):
        rw = None if r_weight_of is None else r_weight_of(state)
        mask, new_r, w = fed_select(scores, avail, k_t, state.rates.r, p,
                                    beta, weight_mode=weight_mode,
                                    r_weight=rw)
        new_state = RateTrackState(
            rates=RateState(r=new_r, t=state.rates.t + 1))
        return mask, w, new_state

    return fused


def as_sharded(strategy: SelectionStrategy, *, axis, k_max: int,
               n_pad: int, topk_impl: str = "stream") -> Callable:
    """The blockwise adapter of the client-sharded engine.

    Returns ``select_blk(state, key, avail_blk, k_t, ctx, avail_full=None)
    -> (mask_blk, weights_blk, new_state, completed_full)`` for one shard
    of the client mesh ``axis`` (a ``launch.mesh.ClientMesh``):
    ``avail_blk`` is this shard's block of the client dimension padded to
    ``n_pad``; the strategy ``state`` is replicated (real-N shape on every
    shard).  The scores come from ``score_block`` when the strategy has
    one, else from ``score`` at full (N,) shape and sliced (the
    availability mask gathered first unless ``avail_full`` is given); the
    cut is :func:`selection.sharded_topk_mask`; the selection mask is then
    gathered (packed words) and ``finalize`` runs at full (N,) shape on
    every shard, so r_k and the weights are replicated and identical —
    the same values, key for key, as the single-device path.
    ``completed_full`` is the full-width completed mask (the selection
    mask without a completion hook).
    """
    if strategy.score is None or strategy.finalize is None:
        raise ValueError(
            f"strategy {strategy.name!r} has no score/finalize "
            f"decomposition, so the generic sharded adapter cannot run it; "
            f"build it with topk_strategy(...) or use an unsharded engine")
    n = strategy.n_clients
    if n is None:
        raise ValueError(f"strategy {strategy.name!r} does not declare "
                         f"n_clients; as_sharded needs it to un-pad fields")
    if topk_impl not in sel.TOPK_IMPLS:
        raise ValueError(f"unknown topk_impl {topk_impl!r}; "
                         f"known: {sel.TOPK_IMPLS}")

    def block_of(x: torch.Tensor, off: int, n_local: int) -> torch.Tensor:
        return pad_client_dim(x, n_pad)[off:off + n_local]

    def select_blk(state, key, avail_blk, k_t,
                   ctx: Optional[SelectCtx] = None, avail_full=None):
        n_local = avail_blk.shape[0]
        off = axis.rank * n_local
        if strategy.score_block is not None:
            scores_blk = strategy.score_block(state, key, avail_blk, k_t,
                                              ctx, off, n)
        else:
            if avail_full is None:
                avail_full = all_gather_bits(avail_blk, axis, n)
            scores = strategy.score(state, key, avail_full, k_t, ctx)
            scores_blk = block_of(scores, off, n_local)
        mask_blk = sel.sharded_topk_mask(scores_blk, avail_blk, k_t, axis,
                                         k_max, method=topk_impl)
        mask_full = all_gather_bits(mask_blk, axis, n)
        completed_full = apply_completion(ctx, mask_full)
        weights, new_state = strategy.finalize(state, completed_full, ctx)
        w_blk = block_of(weights.to(torch.float32), off, n_local)
        return mask_blk, w_blk, new_state, completed_full

    return select_blk


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class StrategyEntry(NamedTuple):
    factory: Callable[..., SelectionStrategy]
    host_only: bool = False
    needs_losses: bool = False


class StrategyAlias(NamedTuple):
    """A convenience name = strategy + server-optimizer defaults."""
    strategy: str
    server_opt: Optional[str] = None
    server_lr: Optional[float] = None


STRATEGY_REGISTRY: Dict[str, StrategyEntry] = {}

# FedAdam (Reddi et al. / paper §4) = FedAvg selection + Adam server step.
STRATEGY_ALIASES: Dict[str, StrategyAlias] = {
    "fedadam": StrategyAlias("fedavg", server_opt="adam", server_lr=1e-2),
}


def register_strategy(name: str, factory: Optional[Callable] = None, *,
                      host_only: bool = False, needs_losses: bool = False,
                      overwrite: bool = False):
    """Register ``factory(n_clients, p, **hyper) -> SelectionStrategy``;
    usable as a decorator.  ``host_only`` keeps the strategy off the device
    engines (``run_spec`` falls back to the host loop with a warning);
    ``needs_losses`` asks the host loop for fresh per-client losses in
    ``ctx.losses`` each round (and implies host-only)."""

    def deco(f):
        key = name.lower()
        if not overwrite and key in STRATEGY_REGISTRY:
            raise KeyError(f"strategy {key!r} already registered")
        STRATEGY_REGISTRY[key] = StrategyEntry(
            factory=f, host_only=host_only or needs_losses,
            needs_losses=needs_losses)
        return f

    return deco(factory) if factory is not None else deco


def list_strategies() -> list:
    return sorted(STRATEGY_REGISTRY)


def get_strategy_entry(name: str) -> StrategyEntry:
    """Registry lookup that fails fast with the registered names."""
    key = str(name).lower()
    if key not in STRATEGY_REGISTRY:
        raise KeyError(
            f"unknown selection strategy {name!r}; registered: "
            f"{list_strategies()} (aliases: {sorted(STRATEGY_ALIASES)})")
    return STRATEGY_REGISTRY[key]


def resolve_strategy(name: str, server_opt: str = "sgd",
                     server_lr: Optional[float] = None):
    """Resolve aliases and server-optimizer defaults in ONE place, as the
    JAX package does: returns ``(strategy_name, server_opt, server_lr)``;
    ``fedadam`` rewrites to fedavg with an Adam server step, and
    ``server_lr=None`` fills with the optimizer's default (1e-2 for
    adam/yogi, else 1.0)."""
    key = str(name).lower()
    if key in STRATEGY_ALIASES:
        alias = STRATEGY_ALIASES[key]
        key = alias.strategy
        if alias.server_opt is not None:
            server_opt = alias.server_opt
        if server_lr is None and alias.server_lr is not None:
            server_lr = alias.server_lr
    get_strategy_entry(key)
    if server_lr is None:
        server_lr = 1e-2 if server_opt in ("adam", "yogi") else 1.0
    return key, server_opt, server_lr


_ENGINE_DEFAULT_KEYS = frozenset(
    {"beta", "positively_correlated", "clients_per_round", "select_impl"})


def make_strategy(name: str, n_clients: int, p, *, device=None,
                  **hyper) -> SelectionStrategy:
    """Instantiate a registered strategy for (n_clients, p) on ``device``
    (default CUDA).  Unknown hyperparameters other than the
    engine defaults raise ``TypeError``."""
    entry = get_strategy_entry(name)
    params = inspect.signature(entry.factory).parameters
    unknown = set(hyper) - set(params) - _ENGINE_DEFAULT_KEYS
    if unknown:
        accepted = sorted(set(params) - {"n_clients", "p", "device"})
        raise TypeError(f"strategy {name!r} factory does not accept "
                        f"{sorted(unknown)}; its hyperparameters are "
                        f"{accepted}")
    hyper = {k: v for k, v in hyper.items() if k in params}
    p = torch.as_tensor(p, dtype=torch.float32,
                        device=resolve_device(device))
    strategy = entry.factory(n_clients=n_clients, p=p, device=p.device,
                             **hyper)
    # the registry's routing flags hold even where the factory left them
    # unset on the instance: the host loop reads the instance's
    return strategy._replace(
        needs_losses=strategy.needs_losses or entry.needs_losses,
        host_only=strategy.host_only or entry.host_only)


# ---------------------------------------------------------------------------
# Built-in strategies
# ---------------------------------------------------------------------------

def _calibrated_r0(n_clients: int, r0, clients_per_round) -> float:
    """Default rate-EMA init r(0): explicit ``r0``, else K/N, else 0.1."""
    if r0 is not None:
        return r0
    if clients_per_round:
        return min(1.0, clients_per_round / n_clients)
    return 0.1


def _rate_init(n_default: int, clients_per_round, device) -> Callable:
    def init(n_clients: int = n_default, r0=None):
        return RateTrackState(rates=init_rates(
            n_clients, _calibrated_r0(n_clients, r0, clients_per_round),
            device=device))
    return init


def _rate_score_block(p: torch.Tensor, positively_correlated: bool,
                      r_of: Callable) -> Callable:
    """Blockwise spelling of the rate-utility score (f3ast family): the
    slice of ``marginal_utility(r, p) * (1 + 1e-6·uniform)`` from the
    block's own r/p rows and the slice-consistent ``core.blockrng``
    tie-break — bitwise the slice of the full-width score, pad lanes 0."""

    def score_block(state, key, avail_blk, k_t, ctx, off, n_total):
        n_local = avail_blk.shape[0]
        ids = off + torch.arange(n_local, device=avail_blk.device)
        real = ids < n_total
        safe = torch.clamp_max(ids, n_total - 1)
        util = marginal_utility(r_of(state)[safe], p[safe],
                                positively_correlated)
        tie = block_uniform(key, n_total, off, n_local)
        return torch.where(real, util * (1.0 + 1e-6 * tie), 0.0)

    return score_block


@register_strategy("f3ast")
def _make_f3ast(n_clients, p, device, beta: float = 1e-3,
                positively_correlated: bool = False,
                clients_per_round: Optional[int] = None,
                select_impl: str = "xla") -> SelectionStrategy:
    """Algorithm 1: greedy −∇H(r) selection, unbiased p_k/r_k weights."""

    def score(state, key, avail, k_t, ctx=None):
        return sel.f3ast_scores(state.rates.r, p, positively_correlated, key)

    def finalize(state, mask, ctx=None):
        # select with r(t−1) (line 4), update the EMA (line 5), aggregate
        # with the *updated* r(t) (line 9)
        new_rates = update_rates(state.rates, mask, beta)
        w = unbiased_weights(p, torch.clamp_min(new_rates.r, R_MIN), mask)
        return w, RateTrackState(rates=new_rates)

    return topk_strategy("f3ast",
                         _rate_init(n_clients, clients_per_round, device),
                         score, finalize, device=device, n_clients=n_clients,
                         select_impl=select_impl,
                         fused=_fused_rate_select(p, beta, "unbiased"),
                         score_block=_rate_score_block(
                             p, positively_correlated,
                             lambda s: s.rates.r))


@register_strategy("fixed_f3ast")
def _make_fixed_f3ast(n_clients, p, device, beta: float = 1e-3,
                      positively_correlated: bool = False, r_target=None,
                      clients_per_round: Optional[int] = None,
                      select_impl: str = "xla") -> SelectionStrategy:
    """Algorithm 2: greedy w.r.t. a *frozen* target rate (the tracked
    r(t−1) when no target is given), weights p_k / r_k(target)."""
    rt_fixed = (None if r_target is None else
                torch.as_tensor(r_target, dtype=torch.float32, device=device))

    def r_of(state):
        return rt_fixed if rt_fixed is not None else state.rates.r

    def score(state, key, avail, k_t, ctx=None):
        # the tie-break of f3ast: under a uniform target every utility ties
        return sel.f3ast_scores(r_of(state), p, positively_correlated, key)

    def finalize(state, mask, ctx=None):
        w = unbiased_weights(p, torch.clamp_min(r_of(state), R_MIN), mask)
        return w, RateTrackState(rates=update_rates(state.rates, mask, beta))

    return topk_strategy("fixed_f3ast",
                         _rate_init(n_clients, clients_per_round, device),
                         score, finalize, device=device, n_clients=n_clients,
                         select_impl=select_impl,
                         fused=_fused_rate_select(p, beta, "unbiased_frozen",
                                                  r_weight_of=r_of),
                         score_block=_rate_score_block(
                             p, positively_correlated, r_of))


def _ema_finalize(beta: float, weights_from_mask: Callable) -> Callable:
    """finalize = rate-EMA step + a weights rule on the (completed) mask."""

    def finalize(state, mask, ctx=None):
        new_rates = update_rates(state.rates, mask, beta)
        return weights_from_mask(mask), RateTrackState(rates=new_rates)

    return finalize


def _log_p(p: torch.Tensor) -> torch.Tensor:
    """log(max(p, 1e-12)) as the JAX engine has it: p is a closed-over
    constant there, so XLA folds the log at compile time, correctly
    rounded (not its runtime ``log``).  Computed once, in float64 on the
    host, rounded to float32."""
    p64 = np.maximum(p.cpu().numpy(), np.float32(1e-12)).astype(np.float64)
    return torch.from_numpy(np.log(p64).astype(np.float32)).to(p.device)


def _gumbel_score(p: torch.Tensor) -> Callable:
    """log p + Gumbel: top-k ⇔ sampling without replacement ∝ p_k."""
    log_p = _log_p(p)

    def score(state, key, avail, k_t, ctx=None):
        return log_p + jr.gumbel(key, tuple(p.shape))

    return score


@register_strategy("fedavg")
def _make_fedavg(n_clients, p, device, beta: float = 1e-3,
                 clients_per_round: Optional[int] = None,
                 select_impl: str = "xla") -> SelectionStrategy:
    """Paper baseline: sample available clients ∝ p_k, plain-mean
    aggregation — biased under intermittent availability."""
    return topk_strategy("fedavg",
                         _rate_init(n_clients, clients_per_round, device),
                         _gumbel_score(p), _ema_finalize(beta,
                                                         uniform_weights),
                         device=device, n_clients=n_clients,
                         select_impl=select_impl,
                         fused=_fused_rate_select(p, beta, "uniform"))


@register_strategy("fedavg_weighted")
def _make_fedavg_weighted(n_clients, p, device, beta: float = 1e-3,
                          clients_per_round: Optional[int] = None,
                          select_impl: str = "xla") -> SelectionStrategy:
    """fedavg's selection with weights ∝ p_k over the cohort."""
    return topk_strategy("fedavg_weighted",
                         _rate_init(n_clients, clients_per_round, device),
                         _gumbel_score(p),
                         _ema_finalize(beta,
                                       lambda mask: fedavg_weights(p, mask)),
                         device=device, n_clients=n_clients,
                         select_impl=select_impl,
                         fused=_fused_rate_select(p, beta, "fedavg"))


@register_strategy("uniform")
def _make_uniform(n_clients, p, device, beta: float = 1e-3,
                  clients_per_round: Optional[int] = None,
                  select_impl: str = "xla") -> SelectionStrategy:
    """Uniform without replacement over the available set, weights 1/|S|."""

    def score(state, key, avail, k_t, ctx=None):
        return jr.uniform(key, tuple(avail.shape))

    return topk_strategy("uniform",
                         _rate_init(n_clients, clients_per_round, device),
                         score, _ema_finalize(beta, uniform_weights),
                         device=device, n_clients=n_clients,
                         select_impl=select_impl,
                         fused=_fused_rate_select(p, beta, "uniform"))


@register_strategy("poc", needs_losses=True)
def _make_poc(n_clients, p, device, beta: float = 1e-3, d: int = 30,
              clients_per_round: Optional[int] = None,
              select_impl: str = "xla") -> SelectionStrategy:
    """Power-of-Choice (Cho et al.): d candidates ∝ p_k, keep the top K_t
    by current local loss, weights 1/|S|.  Host-only: the two-stage draw
    reads fresh per-client losses the device engine does not have.  On
    CUDA both cuts run ``fed_select_mask``: two launches a round."""
    topk = _topk_fn(_check_select_impl(select_impl),
                    torch.device(device).type == "cuda")

    def select(state, key, avail, k_t, ctx: Optional[SelectCtx] = None):
        losses = None if ctx is None else ctx.losses
        if losses is None:
            raise ValueError("'poc' needs ctx.losses (fresh per-client "
                             "losses of the current global model)")
        mask = sel.poc_select(key, avail, k_t, p, losses, d, topk=topk)
        completed = apply_completion(ctx, mask)
        new_rates = update_rates(state.rates, completed, beta)
        return (mask, uniform_weights(completed),
                RateTrackState(rates=new_rates))

    return SelectionStrategy(name="poc",
                             init=_rate_init(n_clients, clients_per_round,
                                             device),
                             select=select, n_clients=n_clients,
                             needs_losses=True, host_only=True)
