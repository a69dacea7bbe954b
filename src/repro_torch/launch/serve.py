"""Batched serving launcher: prefill + decode loop — port of
``repro.launch.serve``.

Prompts are prefilled (filling the KV caches; self-attention through the
``flash_attention`` kernel on the card), then decoded token by token with
greedy or temperature sampling. Params are initialised from
``PRNGKey(--seed)`` as the JAX launcher does, so both print the same ids.
Runs on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --smoke \\
      --device cpu --batch 4 --prompt-len 32 --gen 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    # the JAX launcher defaults to mamba2-370m, whose layers are not ported
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    key = jr.PRNGKey(args.seed, device=dev)
    params = M.init_params(cfg, key, dev)
    b, s = args.batch, args.prompt_len
    max_len = s + args.gen

    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)).to(dev)}

    def sample(logits, k):
        if args.temperature <= 0:
            return torch.argmax(logits, -1).to(torch.int32)
        return jr.categorical(k, logits / args.temperature).to(torch.int32)

    _sync(dev)
    t0 = time.time()
    logits, caches = M.prefill(cfg, params, batch, max_len=max_len)
    _sync(dev)
    t_prefill = time.time() - t0

    tok = sample(logits, key)
    out_tokens = [tok]
    t0 = time.time()
    for i in range(args.gen - 1):
        key, sub = jr.split(key)
        logits, caches = M.serve_step(cfg, params, tok, s + i, caches)
        tok = sample(logits, sub)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.time() - t0
    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={b} prompt={s} gen={gen.shape[1]}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   "
          f"decode: {t_decode/max(args.gen-1,1)*1e3:.2f} ms/token")
    print("sample output ids:", gen[0][:12])
    return gen


if __name__ == "__main__":
    main()
