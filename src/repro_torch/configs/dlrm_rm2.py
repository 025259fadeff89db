"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse, embed 64,
bot 13-512-256-64, top 512-512-256-1, dot interaction.

The reference's shapes: train_batch (65,536, :func:`make_train_step`),
serve_p99 (batch 512, online), serve_bulk (262,144, offline),
retrieval_cand (1 query x 1M candidates).  The dry-run's cells (``CELLS``)
shard the tables row-wise over ``model``, the batch over (pod, data) and
retrieval's candidates over (pod, data); the MLPs are replicated.
"""
from __future__ import annotations

import torch

from repro_torch.models.recsys.dlrm import (DLRMConfig, dlrm_forward,
                                            dlrm_loss, retrieval_scores,
                                            rm2_vocab_sizes)
from repro_torch.train import AdamWState, adamw_update, value_and_grad

from .common import Built, Cell, Spec, dp_axes_of, sds

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


# ---------------------------------------------------------------------------
# the dry-run's cells
# ---------------------------------------------------------------------------
def _params_abstract(cfg: DLRMConfig) -> dict:
    """``init_dlrm``'s stand-ins (fp32)."""
    n_int = cfg.n_sparse + 1
    d_int = n_int * (n_int - 1) // 2 + cfg.embed_dim

    def mlp(dims):
        return [{"w": sds((a, b)), "b": sds((b,))}
                for a, b in zip(dims, dims[1:])]

    return {"tables": [sds((v, cfg.embed_dim)) for v in cfg.vocab_sizes],
            "bot": mlp([cfg.n_dense, *cfg.bot_mlp]),
            "top": mlp([d_int, *cfg.top_mlp])}


def _param_specs(cfg: DLRMConfig) -> dict:
    return {
        "tables": [Spec("model", None)] * cfg.n_sparse,
        "bot": [{"w": Spec(), "b": Spec()} for _ in cfg.bot_mlp],
        "top": [{"w": Spec(), "b": Spec()} for _ in cfg.top_mlp],
    }


def _ids(batch: int, cfg: DLRMConfig):
    return sds((batch, cfg.n_sparse, cfg.multi_hot), torch.int32)


def build_train(cfg: DLRMConfig, batch: int):
    def builder(mesh):
        dp = dp_axes_of(mesh)
        params_a = _params_abstract(cfg)
        p_spec = _param_specs(cfg)
        opt_a = AdamWState(step=sds((), torch.int32), mu=params_a,
                           nu=params_a)
        o_spec = AdamWState(step=Spec(), mu=p_spec, nu=p_spec)
        args = (params_a, opt_a, sds((batch, cfg.n_dense)), _ids(batch, cfg),
                sds((batch,)))
        in_sh = (p_spec, o_spec, Spec(dp, None), Spec(dp, None, None),
                 Spec(dp))
        return Built(fn=make_train_step(cfg), args=args, in_shardings=in_sh,
                     model_flops=dlrm_model_flops(cfg, batch, "train"))
    return builder


def build_serve(cfg: DLRMConfig, batch: int):
    def builder(mesh):
        dp = dp_axes_of(mesh)

        def serve(params, dense, sparse):
            return dlrm_forward(params, cfg, dense, sparse)

        args = (_params_abstract(cfg), sds((batch, cfg.n_dense)),
                _ids(batch, cfg))
        in_sh = (_param_specs(cfg), Spec(dp, None), Spec(dp, None, None))
        return Built(fn=serve, args=args, in_shardings=in_sh,
                     model_flops=dlrm_model_flops(cfg, batch, "serve"))
    return builder


def build_retrieval(cfg: DLRMConfig, n_candidates: int):
    def builder(mesh):
        dp = dp_axes_of(mesh)

        def retrieve(params, dense, sparse, cand_emb):
            return retrieval_scores(params, cfg, dense, sparse, cand_emb)

        args = (_params_abstract(cfg), sds((1, cfg.n_dense)), _ids(1, cfg),
                sds((n_candidates, cfg.embed_dim)))
        in_sh = (_param_specs(cfg), Spec(None, None), Spec(None, None, None),
                 Spec(dp, None))
        flops = 2.0 * n_candidates * cfg.embed_dim \
            + dlrm_model_flops(cfg, 1, "serve")
        return Built(fn=retrieve, args=args, in_shardings=in_sh,
                     model_flops=flops)
    return builder


CELLS = [
    Cell("dlrm-rm2", "train_batch", "train", build_train(CONFIG, 65536)),
    Cell("dlrm-rm2", "serve_p99", "serve", build_serve(CONFIG, 512)),
    Cell("dlrm-rm2", "serve_bulk", "serve", build_serve(CONFIG, 262144)),
    Cell("dlrm-rm2", "retrieval_cand", "retrieval",
         build_retrieval(CONFIG, 1_000_000)),
]
