"""Serving: batched greedy autoregressive decode of an assigned
architecture — the deployment path of the federated global model (port of
``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch llama3.2-1b [--full]
  python -m repro_torch.launch.serve --arch qwen3-8b [--full]
  python -m repro_torch.launch.serve --arch qwen3-14b [--full]
  python -m repro_torch.launch.serve --arch gemma-7b [--full]
  python -m repro_torch.launch.serve --arch mamba2-2.7b [--full]
  python -m repro_torch.launch.serve --arch mixtral-8x22b [--full]
  python -m repro_torch.launch.serve --arch grok-1-314b [--full]
  python -m repro_torch.launch.serve --arch recurrentgemma-2b [--full]
  python -m repro_torch.launch.serve --arch llava-next-34b [--full]
  python -m repro_torch.launch.serve --arch whisper-small [--full]

The smoke config is the default (``--smoke`` spells it out); ``--full``
serves the full-width config (mixtral-8x22b's 281 GB and grok-1-314b's
633 GB of bf16 weights are more than one card holds, and llava-next-34b's
68.9 GB nearly fill it; :func:`serve`'s ``n_layers`` cuts the depth and
keeps every width).  Runs on CUDA
unless ``--device cpu`` is given.  The prompt is drawn with
the port's threefry, so it is the JAX package's prompt for the same seed;
the weights are random from the same seed (``transformer.init_params``).
Decode steps a KV cache (dense, moe: each token routed to its experts;
vlm: text only, as the JAX package serves it), the O(1) recurrent state
(mamba2) or both (recurrentgemma: the RG-LRU state, and the local
attention's cache, a ring of its window once ``max_len`` reaches it);
whisper's decoder steps its self-attention cache against the cross K/V
that ``encdec.prefill`` computes once from the stub frames (drawn from
the seed's second key, float32 cast to the model's dtype).  No
full-sequence kernel (flash attention, ssd_chunk) runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import random as jr
from ..configs import get_arch
from ..device import resolve_device
from ..models import get_model_api


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray        # (batch, steps) greedy tokens
    prompt: np.ndarray        # (batch, prompt_len)
    decode_s: float           # wall time of the greedy loop
    tokens_per_s: float       # steps * batch / decode_s


def serve_config(arch_id: str, smoke: bool = True, n_layers=None):
    """The config :func:`serve` runs: the arch's smoke or full config, cut
    to its first ``n_layers`` layers when given (an encoder-decoder's
    encoder too)."""
    arch = get_arch(arch_id)
    cfg = arch.smoke_model if smoke else arch.model
    if not n_layers:
        return cfg
    enc = {"n_enc_layers": n_layers} if cfg.n_enc_layers else {}
    return cfg.replace(n_layers=n_layers, **enc)


def serve(arch_id: str, batch: int = 4, prompt_len: int = 16,
          steps: int = 32, max_len: int = 128, seed: int = 0,
          smoke: bool = True, log_fn=print, device=None,
          params=None, n_layers=None) -> ServeResult:
    """Step the prompt through ``decode_step``, then decode ``steps``
    greedy tokens (``max_len`` sizes the KV cache, up to a windowed
    attention's ring; mamba2's and the RG-LRU's states do not grow with
    it).  The loop keeps the tokens on the device and waits for
    it once, at the end.  ``params`` are weights already on ``device``
    for this config (e.g. :func:`serve_params`' for this seed); None
    draws them.  ``n_layers`` cuts the config's depth
    (:func:`serve_config`)."""
    device = resolve_device(device)
    cfg = serve_config(arch_id, smoke, n_layers)
    api = get_model_api(cfg)
    # (params, audio frames, prompt) keys, as the JAX package splits them
    _, k_frames, k_prompt = jr.split(jr.PRNGKey(seed, device=device), 3)
    if params is None:
        params = serve_params(arch_id, seed, smoke, device, n_layers)
    state = api.init_decode_state(batch, max_len, device)
    if cfg.family == "audio":
        frames = jr.normal(k_frames, (batch, cfg.enc_seq, cfg.d_model))
        state = api.module.prefill(cfg, params,
                                   {"frames": frames.to(cfg.torch_dtype)},
                                   state)
    prompt = jr.randint(k_prompt, (batch, prompt_len), 0, cfg.vocab)

    # prefill by stepping the prompt (cache-consistent by construction)
    for i in range(prompt_len):
        logits, state = api.decode_step(params, state, prompt[:, i:i + 1])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = []
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
        logits, state = api.decode_step(params, state, tok)
    toks = torch.cat(out, dim=1).cpu().numpy()
    finite = bool(torch.isfinite(logits).all())
    dt = time.perf_counter() - t0
    log_fn(f"[{arch_id}] decoded {steps} steps x batch {batch} in {dt:.2f}s "
           f"({steps * batch / dt:.1f} tok/s); sample: {toks[0, :12].tolist()}")
    if not finite:
        raise FloatingPointError(f"[{arch_id}] non-finite logits")
    return ServeResult(tokens=toks, prompt=prompt.cpu().numpy(), decode_s=dt,
                       tokens_per_s=steps * batch / dt)


def serve_params(arch_id: str, seed: int = 0, smoke: bool = True,
                 device=None, n_layers=None):
    """The weights :func:`serve` draws for ``arch_id`` at ``seed``: from
    the first of the seed key's three (params, audio frames, prompt)."""
    device = resolve_device(device)
    cfg = serve_config(arch_id, smoke, n_layers)
    key = jr.split(jr.PRNGKey(seed, device=device), 3)[0]
    return get_model_api(cfg).init_params(key, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--full", action="store_true",
                      help="the full-width config")
    size.add_argument("--smoke", action="store_true",
                      help="the smoke config (the default)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve(args.arch, batch=args.batch, steps=args.steps, smoke=not args.full,
          device=args.device)


if __name__ == "__main__":
    main()
