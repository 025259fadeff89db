"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction.

The reference's shapes: train_batch (65,536, :func:`make_train_step`),
serve_p99 (batch 512, online), serve_bulk (262,144, offline),
retrieval_cand (1 query x 1M candidates).
"""
from __future__ import annotations

from repro_torch.models.recsys.dlrm import (DLRMConfig, dlrm_loss,
                                            rm2_vocab_sizes)
from repro_torch.train import adamw_update, value_and_grad

from .common import cells_not_ported

CONFIG = DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64,
                    vocab_sizes=rm2_vocab_sizes(26),
                    bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1),
                    multi_hot=1)

SMOKE_CONFIG = DLRMConfig(n_dense=13, n_sparse=6, embed_dim=16,
                          vocab_sizes=(50, 80, 100, 40, 60, 30),
                          bot_mlp=(32, 16), top_mlp=(64, 1), multi_hot=1)


def dlrm_model_flops(cfg: DLRMConfig, batch: int, kind: str) -> float:
    """Model FLOPs of ``batch`` items: the two MLPs, the dot interaction
    and the bag sums; 3x for a train step."""
    dims = [cfg.n_dense, *cfg.bot_mlp]
    bot = sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    nf = cfg.n_sparse + 1
    d_int = nf * (nf - 1) // 2 + cfg.embed_dim
    dims = [d_int, *cfg.top_mlp]
    top = sum(2.0 * a * b for a, b in zip(dims, dims[1:]))
    inter = 2.0 * nf * nf * cfg.embed_dim
    emb = 2.0 * cfg.n_sparse * cfg.multi_hot * cfg.embed_dim
    per_item = bot + top + inter + emb
    return (3.0 if kind == "train" else 1.0) * per_item * batch


def make_train_step(cfg: DLRMConfig, lr: float = 1e-3):
    """(params, opt_state, dense, sparse, labels) -> (params, opt_state,
    loss): the body of the reference's ``build_train`` step without a
    mesh -- the gradient of ``dlrm_loss`` (dense, every table row), then
    one AdamW step, no clipping.  Parameters and state are updated in
    place and returned (``adamw_update``)."""
    grad_fn = value_and_grad(dlrm_loss)

    def step(params, opt_state, dense, sparse, labels):
        loss, grads = grad_fn(params, cfg, dense, sparse, labels)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, loss

    return step

# the dry-run cells: ROADMAP.md Queue 1 item 5.4
__getattr__ = cells_not_ported(__name__)
