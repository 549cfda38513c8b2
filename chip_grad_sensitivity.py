#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s depth-2 training check fails a wrong
attention gradient, on one GPU.

    python3 chip_grad_sensitivity.py   # from the root of a checkout

Runs ``zoo_train``'s depth-2 float32 round (llama3.2-1b at its full
widths, 2 layers, K = 2, E = 1, B = 1, S = 512, through
``launch.steps.build_train_step`` and ``launch.train.federated_rounds``)
once as committed, then once for each perturbation of the backward
kernel's output, each wrapped around ``flash_attention_bwd`` for that
round alone:

* ``dk_last_head_x1.01``   dK of the last KV head times 1.01;
* ``dq_x1.001``            dQ times 1.001;
* ``dq_x1.0001``           dQ times 1.0001;
* ``dv_last_64_keys_zero`` dV of the last 64 keys (one key tile) zeroed;
* ``dk_last_64_keys_zero`` dK of the last 64 keys zeroed.

Each perturbed round is held against the committed one as ``zoo_train``
holds the card against the CPU (relative gaps of the loss and the delta
norm; each leaf of the delta, a stacked block leaf per layer: its norm's
relative gap and its largest lane gap over its largest lane), beside
``chip_smoke``'s limits.  A perturbation whose gaps exceed the limits by
more than the card-vs-CPU gaps is one the check fails.  Prints the card's
name and power limit, then one JSON line.  Measurement only: nothing here
is on a path of the port.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PERTURBATIONS = ("dk_last_head_x1.01", "dq_x1.001", "dq_x1.0001",
                 "dv_last_64_keys_zero", "dk_last_64_keys_zero")


def perturb(kind, dq, dk, dv):
    if kind == "dk_last_head_x1.01":
        dk[:, :, -1, :] *= 1.01
    elif kind == "dq_x1.001":
        dq *= 1.001
    elif kind == "dq_x1.0001":
        dq *= 1.0001
    elif kind == "dv_last_64_keys_zero":
        dv[:, -64:] = 0
    elif kind == "dk_last_64_keys_zero":
        dk[:, -64:] = 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_grad_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch import random as jr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import federated_rounds
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    print(cs.gpu_line(), flush=True)
    arch = cs.zoo_depth2_arch()
    key = jr.PRNGKey(1, device=dev)
    params = transformer.init_params(arch.model, key, dev)
    fed_round, opt, _ = build_train_step(arch, "train_4k")

    def run():
        _, _, m, state = next(federated_rounds(
            fed_round, params, opt.init(params), key,
            vocab=arch.model.vocab, shape=cs.ZOO_DEPTH2_SHAPE, rounds=1))
        return (float(m.loss), float(m.delta_norm),
                cs._tree_to(state.m, "cpu"))

    loss, dnorm, moment = run()
    committed = fa.flash_attention_bwd
    rows = {}
    for kind in PERTURBATIONS:
        def wrapped(*args, _kind=kind, **kwargs):
            grads = committed(*args, **kwargs)
            perturb(_kind, *grads)
            return grads

        wrapped.launches = 0
        fa.flash_attention_bwd = wrapped
        try:
            p_loss, p_dnorm, p_moment = run()
        finally:
            fa.flash_attention_bwd = committed
        gaps = cs.delta_leaf_gaps(torch, p_moment, moment)
        rel = dict(loss=abs(p_loss - loss) / loss,
                   delta_norm=abs(p_dnorm - dnorm) / dnorm)
        worst = [max(g[i] for g in gaps.values()) for i in (0, 1)]
        rows[kind] = dict(
            relative_errors=rel, worst_leaf_norm_gap=worst[0],
            worst_leaf_max_gap=worst[1],
            fails_check=(max(rel.values()) > cs.ZOO_TOL
                         or worst[0] > cs.ZOO_LEAF_NORM_TOL
                         or worst[1] > cs.ZOO_LEAF_MAX_TOL),
            attention_leaves={n: g for n, g in gaps.items() if "attn" in n})
    print(json.dumps(dict(limits=dict(
        loss_and_delta_norm=cs.ZOO_TOL, leaf_norm=cs.ZOO_LEAF_NORM_TOL,
        leaf_max=cs.ZOO_LEAF_MAX_TOL), perturbations=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
