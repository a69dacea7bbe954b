"""Batched serving example: prefill a batch of prompts, then stream
decode — the PyTorch port of ``examples/serve_decode.py``. It shows the
sub-quadratic decode paths (the mamba2 state, the jamba hybrid, mixtral's
sliding-window ring buffer) that make long_500k serveable; the
cross-attention archs (seamless-m4t-medium, llama-3.2-vision-11b) take
zero frames or patches, as the JAX example does. Runs on the card unless
given ``--device cpu``:

    PYTHONPATH=src python examples/torch/serve_decode.py \\
        --arch jamba-v0.1-52b [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.smoke_config(args.arch)
    params = M.init_params(cfg, jr.PRNGKey(0), dev)
    rng = np.random.default_rng(0)
    b, s = args.batch, args.prompt
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)).to(dev),
        **M.zero_memory(cfg, b, dev)}

    logits, caches = M.prefill(cfg, params, batch, max_len=s + args.gen)
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    t0 = time.time()
    for i in range(args.gen - 1):
        logits, caches = M.serve_step(cfg, params, tok, s + i, caches)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    gen = torch.stack(out, 1).cpu().numpy()   # waits for the device
    ms = (time.time() - t0) / max(args.gen - 1, 1) * 1e3
    print(f"arch={args.arch} family={cfg.family} "
          f"subquadratic={cfg.subquadratic}")
    print(f"decoded {args.gen} tokens x {b} seqs, {ms:.1f} ms/token "
          f"({dev.type})")
    print("first sequence:", gen[0].tolist())
    return {"tokens": gen}


if __name__ == "__main__":
    main()
