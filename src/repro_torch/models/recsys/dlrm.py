"""DLRM RM2 (arXiv:1906.00091) in PyTorch, the port of ``repro``'s
``models/recsys/dlrm.py``: sparse embeddings -> dot interaction -> MLPs,
for serving, retrieval and training (the train step is
``configs/dlrm_rm2.py``'s ``make_train_step``).

Each field's sum-mode bag runs through the hand-written ``embedding_bag``
kernel on a card (its plain version on the CPU): the reference's
``take`` + sum is the contract the TPU kernel implements.  When the
tables require a gradient the wrapper goes through ``EmbeddingBagFn``,
whose backward is the bag's transpose (a dense table gradient).  The
retrieval shape scores one query against N candidates with one
matrix-vector product.

On ``DTensor`` s (the dry-run's cells: tables row-sharded over ``model``,
the batch over the data axes) each bag runs per shard of its table
(``kernels/embedding_bag/sharding.py``) and its partial sum over
``model`` is all-reduced; the interaction's pair pick runs per batch
shard.  Every other op is DTensor's own.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models.gnn.common import init_mlp, mlp
from repro_torch.utils import is_dtensor


class DLRMConfig(NamedTuple):
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: tuple[int, ...] = ()          # len == n_sparse
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    multi_hot: int = 1                         # lookups per field (bag size)


def rm2_vocab_sizes(n_sparse: int = 26, seed: int = 7) -> tuple[int, ...]:
    """Criteo-like skewed table sizes: a few huge tables, many small."""
    rng = np.random.default_rng(seed)
    sizes = 10 ** rng.uniform(3.0, 7.0, size=n_sparse)
    sizes[:3] = [10_000_000, 8_000_000, 4_000_000]  # the heavy hitters
    # rows in multiples of 256, as the reference shards tables over `model`
    return tuple(int(-(-int(s) // 256) * 256) for s in sizes)


def init_dlrm(gen: torch.Generator, cfg: DLRMConfig, dtype=torch.float32,
              device="cuda") -> dict:
    """The reference's parameters, drawn from ``gen`` (a generator of
    ``device``): each table N(0, 1) / sqrt(embed_dim), the MLPs as
    ``init_mlp`` draws them."""
    tables = [(torch.randn((v, cfg.embed_dim), generator=gen,
                           dtype=torch.float32, device=device)
               .div_(np.sqrt(cfg.embed_dim))).to(dtype)
              for v in cfg.vocab_sizes]
    n_int = cfg.n_sparse + 1          # interaction features incl. dense
    d_int = n_int * (n_int - 1) // 2 + cfg.embed_dim
    return {
        "tables": tables,
        "bot": init_mlp(gen, [cfg.n_dense, *cfg.bot_mlp], dtype, device),
        "top": init_mlp(gen, [d_int, *cfg.top_mlp], dtype, device),
    }


def params_from_numpy(tree, cfg: DLRMConfig, device="cuda") -> dict:
    """The port's DLRM parameters from the reference's tree (``np.asarray``
    of each leaf of ``init_dlrm``'s): the same structure, each leaf an
    fp32 tensor on ``device``.  Raises on a tree that is not ``cfg``'s."""
    n_int = cfg.n_sparse + 1
    want = {"tables": [(v, cfg.embed_dim) for v in cfg.vocab_sizes],
            "bot": [cfg.n_dense, *cfg.bot_mlp],
            "top": [n_int * (n_int - 1) // 2 + cfg.embed_dim, *cfg.top_mlp]}
    if set(tree) != set(want) or len(tree["tables"]) != cfg.n_sparse:
        raise ValueError(f"a DLRM tree has keys {sorted(want)} and "
                         f"{cfg.n_sparse} tables")

    def tensor(a, shape, path):
        t = torch.as_tensor(np.asarray(a, np.float32), device=device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{path} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        return t

    params = {"tables": [tensor(t, s, f"tables/{i}") for i, (t, s) in
                         enumerate(zip(tree["tables"], want["tables"]))]}
    for name in ("bot", "top"):
        dims = want[name]
        if len(tree[name]) != len(dims) - 1:
            raise ValueError(f"{name} has {len(tree[name])} layers, "
                             f"expected {len(dims) - 1}")
        params[name] = [
            {"w": tensor(p["w"], (a, b), f"{name}/{i}/w"),
             "b": tensor(p["b"], (b,), f"{name}/{i}/b")}
            for i, (p, a, b) in enumerate(zip(tree[name], dims, dims[1:]))]
    return params


def _bags(params, sparse_idx: torch.Tensor, bag) -> list[torch.Tensor]:
    """Each field's sum-mode bag ``[B, d]``: ``sparse_idx [B, F, hot]`` is
    laid out field-major once, so that every field's ids are the
    contiguous int32 ``[B, hot]`` the kernel takes."""
    idx = sparse_idx.to(torch.int32).permute(1, 0, 2).contiguous()
    out = [bag(t, idx[f]) for f, t in enumerate(params["tables"])]
    if is_dtensor(sparse_idx):
        out = [_replicated(o) for o in out]
    return out


def _replicated(x):
    """A ``DTensor`` with its partial sums reduced (an all-reduce)."""
    from torch.distributed.tensor import Partial, Replicate
    lay = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x if lay == list(x.placements) else x.redistribute(
        x.device_mesh, lay)


def _pairs(inter: torch.Tensor, iu, ju) -> torch.Tensor:
    """``inter[:, iu, ju]``; on a ``DTensor`` per shard of its batch."""
    if not is_dtensor(inter):
        return inter[:, iu, ju]
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    lay = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in inter.placements]
    return local_map(lambda t: t[:, iu, ju], out_placements=lay,
                     in_placements=(lay,), device_mesh=inter.device_mesh,
                     redistribute_inputs=True)(inter)


def dlrm_forward(params, cfg: DLRMConfig, dense: torch.Tensor,
                 sparse_idx: torch.Tensor, *, bag=None) -> torch.Tensor:
    """dense ``[B, n_dense]``; sparse_idx ``[B, n_sparse, multi_hot]`` ->
    logits ``[B]``.  ``bag`` replaces the ``embedding_bag`` kernel (its
    plain version for a comparison, differentiated by autograd)."""
    x_dense = mlp(params["bot"], dense, act=F.relu)            # [B, d]
    embs = _bags(params, sparse_idx, bag or embedding_bag)     # [B, d] each
    feats = torch.stack([x_dense] + embs, dim=1)               # [B, F, d]
    inter = torch.bmm(feats, feats.transpose(1, 2))            # dot interaction
    iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], 1,
                                device=feats.device)
    z = torch.cat([x_dense, _pairs(inter, iu, ju)], dim=-1)
    return mlp(params["top"], z, act=F.relu)[:, 0]


def dlrm_loss(params, cfg: DLRMConfig, dense, sparse_idx, labels, *,
              bag=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``labels`` (the
    reference's stable form)."""
    logits = dlrm_forward(params, cfg, dense, sparse_idx, bag=bag)
    return torch.mean(logits.clamp(min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def retrieval_scores(params, cfg: DLRMConfig, query_dense: torch.Tensor,
                     query_sparse: torch.Tensor, cand_emb: torch.Tensor, *,
                     bag=None) -> torch.Tensor:
    """Two-tower retrieval: one query vs n_candidates (one matrix-vector
    product).  query_dense ``[1, n_dense]``; query_sparse ``[1, n_sparse,
    hot]``; cand_emb ``[N, d]`` precomputed item tower -> scores ``[N]``."""
    x_dense = mlp(params["bot"], query_dense, act=F.relu)
    embs = _bags(params, query_sparse, bag or embedding_bag)
    q = x_dense + sum(embs)                                    # [1, d]
    return (cand_emb @ q[0]).float()
