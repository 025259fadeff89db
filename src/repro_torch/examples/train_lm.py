"""Train a ~100M-parameter qwen2-family model for a few hundred steps, with
checkpointing: the port of ``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 12 --batch 2 --seq 32
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import tree_flatten
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.model import init_params
from repro_torch.models.lm.steps import init_opt_state, make_train_step


def sample_batch(rng, batch: int, seq: int, vocab: int) -> np.ndarray:
    """A synthetic corpus with learnable structure: Zipf tokens whose odd
    positions copy the even ones."""
    z = rng.zipf(1.5, size=(batch, seq)).clip(0, vocab - 1)
    z[:, 1::2] = z[:, 0::2]
    return z


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no card is present")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # ~100M params: 8L x d512 x ff2048, 32k vocab
    cfg = LMConfig(name="qwen2-100m", n_layers=8, d_model=512, n_heads=8,
                   n_kv_heads=2, d_ff=2048, vocab=32768, d_head=64,
                   activation="swiglu", qkv_bias=True, max_seq=args.seq,
                   attn_chunk=64, param_dtype="float32",
                   compute_dtype="float32")
    params = init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    n = sum(p.numel() for p in tree_flatten(params))
    print(f"model: {n / 1e6:.1f}M params")

    opt = init_opt_state(cfg, params)
    step = make_train_step(cfg, lr=1e-3)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="lm_ckpt_") as ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir, every=100)
        t0, losses = time.perf_counter(), []
        for i in range(args.steps):
            tokens = torch.as_tensor(sample_batch(rng, args.batch, args.seq,
                                                  cfg.vocab), device=dev)
            params, opt, metrics = step(params, opt, tokens)
            losses.append(float(metrics["loss"]))
            ckpt.maybe_save(params, i)
            if i % 50 == 0 or i == args.steps - 1:
                print(f"step {i:4d}  loss {losses[-1]:.3f}")
        dt = time.perf_counter() - t0
    print(f"first-10-avg {np.mean(losses[:10]):.3f} -> last-10-avg "
          f"{np.mean(losses[-10:]):.3f} (must decrease); "
          f"{args.steps * args.batch * args.seq / dt:.0f} tok/s on {dev}")
    if not np.mean(losses[-10:]) < np.mean(losses[:10]):
        raise SystemExit("training must learn")


if __name__ == "__main__":
    main()
