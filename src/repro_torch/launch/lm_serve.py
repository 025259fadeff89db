"""LM serving entry point: prefill + batched greedy decode on a reduced LM
config, the port of ``repro``'s ``launch/lm_serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch phi4-mini-3.8b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.lm_serve --device cpu \
        --arch deepseek-v3-671b

Every language model of the registry (dense GQA, MoE, MLA) serves its
REDUCED config.  Runs on ``cuda`` unless ``--device`` says otherwise; a
GQA model's prefill attention runs through the ``flash_attention`` kernel
there, an MLA model's through the plain chunked route.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models.lm.model import init_params
from repro_torch.models.lm.steps import make_decode_step, make_prefill_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = get_arch(args.arch).REDUCED
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    max_seq = args.prompt_len + args.tokens
    prefill = make_prefill_step(cfg, max_seq=max_seq)
    decode = make_decode_step(cfg)

    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           size=(args.batch, args.prompt_len)),
                              dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, prompts)
    last = logits[:, -1].argmax(-1)
    out = [last]
    for i in range(args.tokens - 1):
        lg, caches = decode(params, caches, last, args.prompt_len + i)
        last = lg.argmax(-1)
        out.append(last)
    toks = torch.stack(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    print(f"{cfg.name}: generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s on {dev})")
    print("sample:", toks[0][:12].numpy())
    return toks


if __name__ == "__main__":
    main()
