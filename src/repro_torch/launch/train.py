"""Training driver, the port of ``repro``'s ``launch/train.py``: any LM of
the registry, its REDUCED config (or ``--full-config``), random tokens.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen2-1.5b --steps 3

Runs on ``cuda`` unless ``--device`` says otherwise; a GQA model's
attention runs through the ``flash_attention`` kernel there, forward and
recompute, with its plain-PyTorch backward.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.configs.registry import get_arch
from repro_torch.models.lm.model import init_params
from repro_torch.models.lm.steps import init_opt_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (cluster-size) config instead of the "
                         "reduced smoke config")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.CONFIG if args.full_config else mod.REDUCED
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}")
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    n = sum(p.numel() for p in tree_flatten(params))
    print(f"params: {n:,}")
    opt = init_opt_state(cfg, params)
    step = make_train_step(cfg, lr=args.lr)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(args.steps):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                              size=(args.batch, args.seq)),
                                 device=dev)
        params, opt, metrics = step(params, opt, tokens)
        if ckpt:
            ckpt.maybe_save(params, i)
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    print(f"done: {toks / dt:.0f} tokens/s on {dev}")


if __name__ == "__main__":
    main()
