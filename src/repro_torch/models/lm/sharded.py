"""The LM's code paths on ``DTensor`` s, for the dry-run
(``launch/dryrun.py``).  They run only under ``model.activation_sharding``
(``model._sharded``); every run on real tensors takes the plain paths of
``model.py`` and ``steps.py``.

Where the plain formulation would make DTensor gather a sharded operand
whole, or meets an op DTensor cannot shard, the computation runs per shard
(``local_map``) with the collectives the layout calls for written out,
as the reference's partitioner would insert them:

- :func:`embed`: the vocabulary-parallel embedding gather (each model rank
  looks tokens up in its block of the table; a partial sum over
  ``model``);
- :func:`cross_entropy`: the vocabulary-parallel loss (per-token max, sum
  of exponentials and gold logit reduced over ``model``);
- :func:`moe_ffn`: routing and dispatch per data shard;
- :func:`cache_write` and :func:`decode_attention`: a sequence-sharded
  decode cache written and read per block (flash-decoding: the softmax's
  max and sum and the context reduced over the sequence's ranks);
- :func:`project`: the attention projections, per shard in a layout
  chosen mesh dim by mesh dim.

The replicate rules -- where a sharded tensor is gathered whole on a mesh
dim, and the trace counts the all-gather -- are :func:`gathered` and its
callers, :func:`project`'s "whole" layout, and the attention strategy
of ``kernels/flash_attention/sharding.py``.  The gradients are laid out
where DTensor would choose badly (:func:`reduced`, :func:`grad_like`, the
``in_grad_placements`` of the per-shard paths).
``tests/torch_sharded_ranks.py`` runs these paths on real tensors over
four ranks and holds them against the plain model.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.common import Spec, dp_size_of, placements
from repro_torch.utils import mesh_block

from . import model as _m


def _ctx():
    """(mesh, dp axes as a tuple) of the active activation context."""
    mesh, dp = _m._ACT_SHARDING[0]
    return mesh, dp if isinstance(dp, tuple) else (dp,)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def constrain(x, spec: Spec):
    """``x`` redistributed to ``spec``."""
    mesh, _ = _ctx()
    return x.redistribute(mesh, placements(mesh, spec, x.dim()))


def batch(x):
    """Dim 0 (batch) over the dp axes, if divisible."""
    mesh, dp = _ctx()
    if x.shape[0] % dp_size_of(mesh) != 0:
        return x
    return constrain(x, Spec(dp if len(dp) > 1 else dp[0],
                             *(None,) * (x.dim() - 1)))


def _no_partial(x):
    lay = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    if lay == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, lay)


def reduced(x):
    """The residual stream with its partial sums reduced (a ``DTensor``
    after a row-parallel product is a partial sum over ``model``): the
    all-reduce a tensor-parallel block ends with.  DTensor would carry
    the partial sum on and choose layouts that keep it, down to logits
    the size of the whole batch and vocabulary on every rank.

    The gradient gets the same treatment: the residual stream's gradient
    out of a column-parallel product is a partial sum over ``model``, and
    DTensor, pricing only what it moves, would keep it so and gather the
    next row-parallel product's weight instead, every model rank then
    computing that product's input gradient for its whole batch.  So the
    gradient is reduced here too (the all-reduce a tensor-parallel
    block's backward ends with)."""
    x = _no_partial(x)
    if x.requires_grad:
        x.register_hook(_no_partial)
    return x


def _dp_lay(mesh, dp, d: int, split: bool = True) -> list:
    """Dim ``d`` over the dp axes (of more than one rank), else
    replicated."""
    return [Shard(d) if split and a in dp and mesh.size(i) > 1
            else Replicate() for i, a in enumerate(_names(mesh))]


# ---------------------------------------------------------------------------
# replicate rules and the projections
# ---------------------------------------------------------------------------
def gathered(t, lay):
    """``t`` in the layout ``lay`` (one placement a mesh dim): the replicate
    rule of the LM's DTensor paths -- where a dim sharded in ``t`` is
    replicated in ``lay`` DTensor all-gathers it, and the trace counts
    the all-gather.  Callers: :func:`embed` (the table's data shards, the
    FSDP gather), :func:`microbatches` (the tokens), :func:`unstacked` and
    :func:`flat_weight`."""
    if list(t.placements) == list(lay):
        return t
    return t.redistribute(t.device_mesh, lay)


def unstacked(t):
    """A stacked ``[L, ...]`` parameter with its layer dim gathered where
    a mesh dim shards it (the sanitized specs move an axis the heads
    cannot take onto L when L divides: nemotron's 8 kv heads over 16),
    so it unbinds into layers."""
    return gathered(t, [Replicate() if isinstance(p, Shard) and p.dim == 0
                        else p for p in t.placements])


def flat_weight(w, n: int):
    """``w`` laid out so its first ``n`` dims flatten into one: a mesh dim
    sharding any but the first of them is gathered (``w_o [H, Dh, D]``
    whose ``model`` axis the sanitized spec moved onto Dh)."""
    return gathered(w, [Replicate() if isinstance(p, Shard)
                        and 0 < p.dim < n else p for p in w.placements])


def grad_like(x):
    """``x``, its gradient laid out as ``x`` is.  For a view that merges
    heads into one dim (attention's ``ctx [B, S, H * Dh]``): DTensor may
    shard that dim's gradient in blocks of columns that are not whole
    heads (a slice of a replicated tensor costs it nothing), which the
    view's backward cannot split back into heads."""
    if x.requires_grad:
        mesh, lay = x.device_mesh, list(x.placements)
        x.register_hook(lambda g: g if list(g.placements) == lay
                        else g.redistribute(mesh, lay))
    return x


def project(x, w):
    """``einsum("bsd,dhk->bshk", x, w)`` on ``DTensor`` s, one product per
    shard (``local_map``) in a layout chosen here, mesh dim by mesh dim:
    the batch where x already has it (the dp axes); else the heads where
    the weight's spec shards them and they divide; else x's batch where it
    divides (a local slice); else replicated -- every rank of that dim
    computing the whole projection (qwen2's 12 heads and 2 kv heads,
    phi4-mini's 24 and 8, nemotron's 8 kv heads, against 16, where the
    batch does not split either).  The weight's other shards (the FSDP
    rows, a head-dim shard the sanitized spec made) are gathered: a
    replicate rule, counted.  A column block of the flattened product
    need not be whole heads, which DTensor cannot split back, so DTensor
    never picks this layout itself.  The gradients: the weight's a
    partial sum over the batch's dims, x's over the heads' dims."""
    mesh = x.device_mesh
    H = w.shape[1]
    x_lay, w_lay, out, gx, gw = [], [], [], [], []
    n_batch = 1
    for i in range(mesh.ndim):
        n, px, pw = mesh.size(i), x.placements[i], w.placements[i]
        if n > 1 and isinstance(px, Shard) and px.dim == 0:
            kind = "batch"
        elif n > 1 and isinstance(pw, Shard) and pw.dim == 1 and H % n == 0:
            kind = "heads"
        elif n > 1 and x.shape[0] % (n_batch * n) == 0:
            kind = "batch"
        else:
            kind = "whole"
        if kind == "batch":
            n_batch *= n
            x_lay.append(Shard(0))
            w_lay.append(Replicate())
            out.append(Shard(0))
            gx.append(Shard(0))
            gw.append(Partial())
        elif kind == "heads":
            x_lay.append(Replicate())
            w_lay.append(Shard(1))
            out.append(Shard(2))
            gx.append(Partial())
            gw.append(Shard(1))
        else:
            for lay in (x_lay, w_lay, out, gx, gw):
                lay.append(Replicate())

    def local(xl, wl):
        y = xl @ wl.reshape(wl.shape[0], -1)
        return y.view(*xl.shape[:-1], *wl.shape[1:])

    return local_map(local, out_placements=out, in_placements=(x_lay, w_lay),
                     in_grad_placements=(gx, gw), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


# ---------------------------------------------------------------------------
# embedding and loss: vocabulary-parallel
# ---------------------------------------------------------------------------
def embed(table, tokens):
    """``table[tokens]``: the table's data shards gathered (the FSDP
    gather), each model rank looking the tokens up in its own block of the
    vocabulary (others give zeros), the rows a partial sum over ``model``;
    tokens stay batch-sharded over the dp axes."""
    mesh, dp = _ctx()
    names = _names(mesh)
    split = tokens.shape[0] % dp_size_of(mesh) == 0
    tok = _dp_lay(mesh, dp, 0, split)
    vocab = [i for i, a in enumerate(names)
             if a == "model" and mesh.size(i) > 1
             and table.shape[0] % mesh.size(i) == 0]
    t_lay = [Shard(0) if i in vocab else Replicate()
             for i in range(len(names))]
    table = gathered(table, t_lay)
    if not vocab:
        return table[tokens]
    block, n = mesh_block(mesh, vocab)
    rows = table.shape[0] // n
    lo = block * rows

    def lookup(t, ids):
        idx = ids - lo
        mine = (idx >= 0) & (idx < rows)
        out = t[idx.clamp(0, rows - 1)]
        return out * mine[..., None].to(out.dtype)

    out = [Partial() if i in vocab else p for i, p in enumerate(tok)]
    # each data rank looks up its own rows of the batch: the table's
    # gradient is a partial sum over the dims that split the tokens
    t_grad = [Partial() if isinstance(p, Shard) else t_lay[i]
              for i, p in enumerate(tok)]
    return local_map(lookup, out_placements=out, in_placements=(t_lay, tok),
                     in_grad_placements=(t_grad, tok), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


class _ReplicatedSum(torch.autograd.Function):
    """``x`` summed over ``group`` (an all-reduce), the result held alike by
    every rank of the group.  Each rank's loss is then the same function
    of it, so the gradient of each rank's part is the result's own
    gradient: the backward moves nothing.  (An all-reduce's usual
    backward sums the ranks' gradients, and would count that gradient
    once for each rank.)"""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _vocab_parallel_tokens(logits, targets, groups, v_lo: int):
    """Per-token cross-entropy of one rank's vocabulary block ``logits
    [b, s, V/M]`` (columns ``v_lo ..``): the max, the sum of exponentials
    and the gold logit reduced over the vocabulary's ``groups``."""
    lf = logits.float()
    m = lf.amax(dim=-1).detach()
    for g in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    sumexp = torch.exp(lf - m[..., None]).sum(-1)
    idx = targets.long() - v_lo
    mine = (idx >= 0) & (idx < lf.shape[-1])
    gold = lf.gather(-1, idx.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    gold = gold * mine
    for g in groups:
        sumexp = _ReplicatedSum.apply(sumexp, g)
        gold = _ReplicatedSum.apply(gold, g)
    return m + torch.log(sumexp) - gold


def cross_entropy(logits, targets):
    """The loss of ``DTensor`` logits, vocabulary-parallel as the
    reference's partitioner runs it: each rank reduces its block of the
    vocabulary (batch over the dp axes, vocabulary over ``model``) and
    only per-token statistics cross the model ranks; the logits are never
    gathered whole.  With ``model`` of one rank, the plain loss."""
    mesh, dp = _ctx()
    names = _names(mesh)
    vocab = [i for i, a in enumerate(names)
             if a == "model" and mesh.size(i) > 1
             and logits.shape[-1] % mesh.size(i) == 0]
    if not vocab:
        return None
    split = logits.shape[0] % dp_size_of(mesh) == 0
    lay = _dp_lay(mesh, dp, 0, split)
    v_lay = [Shard(2) if i in vocab else p for i, p in enumerate(lay)]
    block, n = mesh_block(mesh, vocab)
    v_lo = block * (logits.shape[-1] // n)
    groups = [mesh.get_group(i) for i in vocab]
    per_token = local_map(
        lambda lg, t: _vocab_parallel_tokens(lg, t, groups, v_lo),
        out_placements=lay, in_placements=(v_lay, lay), device_mesh=mesh,
        redistribute_inputs=True)(logits, targets)
    return per_token.mean()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_ffn(p, cfg, x):
    """``model.moe_ffn`` on ``DTensor`` s: tokens are routed and dispatched
    per data shard, as the reference's einsum dispatch keeps them
    batch-local -- ``_router``, ``place``, the index dispatch and the
    load-balance counts run on each rank's own batch rows.  Only the
    experts' batched products see the sharded expert weights, so the
    collectives their layout calls for are DTensor's redistributes.  Under
    serving shardings the dispatched tokens are pinned to the
    expert-parallel layout first (the reference's constraint point).  The
    load-balance loss is the reference's over the whole batch: per-shard
    expert counts and probability sums, reduced."""
    mesh, dp = _ctx()
    names = _names(mesh)
    B, S, D = x.shape
    # a batch that does not split over the dp ranks is routed whole on each
    split = B % dp_size_of(mesh) == 0
    m = cfg.moe
    E, K = m.n_experts, m.top_k
    C = _m.capacity(cfg, S)

    def dispatch(xl, router):
        b = xl.shape[0]
        probs, gate, expert = _m._router({"router": router}, cfg, xl)
        r = _m.place(probs, gate, expert, C)
        n = E * b * C
        bi = torch.arange(b, device=xl.device)[:, None, None]
        slot = torch.where(r.keep, (r.expert * b + bi) * C + r.pos, n)
        xe = xl.new_zeros((n + 1, D))
        xe.index_copy_(0, slot.view(-1), xl.reshape(b * S, 1, D)
                       .expand(b * S, K, D).reshape(-1, D))
        w = torch.where(r.keep, r.gate, 0.0).to(xl.dtype)
        counts = torch.zeros(E, dtype=torch.float32,
                             device=xl.device).index_add_(
            0, expert.reshape(-1), torch.ones(expert.numel(),
                                              dtype=torch.float32,
                                              device=xl.device))
        return (xe[:n].view(E, b * C, D), slot, w, counts,
                probs.sum(dim=(0, 1)))

    def combine(ye, slot, w):
        b = slot.shape[0]
        n = ye.shape[0] * ye.shape[1]
        rows = ye.reshape(n, D)[slot.reshape(-1).clamp(max=n - 1)]
        return torch.bmm(w.view(b * S, 1, K), rows.view(b * S, K, D)) \
            .view(b, S, D)

    lay0, lay1 = _dp_lay(mesh, dp, 0, split), _dp_lay(mesh, dp, 1, split)
    # per-shard sums over the batch (the router's gradient among them)
    partial = [Partial() if isinstance(q, Shard) else q for q in lay0]
    rep = [Replicate()] * len(names)
    xe, slot, w, counts, psum = local_map(
        dispatch, out_placements=(lay1, lay0, lay0, partial, partial),
        in_placements=(lay0, rep), in_grad_placements=(lay0, partial),
        device_mesh=mesh, redistribute_inputs=True)(x, p["router"])
    size = {a: mesh.size(i) for i, a in enumerate(names)}
    if cfg.serving_shardings and E % (size["data"] * size["model"]) == 0:
        xe = constrain(xe, Spec(("data", "model"), None, None))
    ye = _m._experts(p, cfg, xe)
    y = local_map(combine, out_placements=lay0,
                  in_placements=(lay1, lay0, lay0), device_mesh=mesh,
                  redistribute_inputs=True)(ye, slot, w)
    if m.n_shared:
        y = y + _m.dense_ffn(p["shared"], cfg, x)
    f = counts * (K / (B * S * K))
    aux = E * (f * (psum / (B * S))).sum() / K
    return y, aux


# ---------------------------------------------------------------------------
# decode: a sequence-sharded cache, per block
# ---------------------------------------------------------------------------
def _seq_dims(cache) -> list:
    return [i for i, p in enumerate(cache.placements)
            if isinstance(p, Shard) and p.dim == 1]


def cache_write(cache, pos: int, new) -> None:
    """``cache[:, pos:pos + S] = new``, in place: each rank writes the
    positions that fall in its own block of the sequence (the same ops on
    every rank, the others rewriting what they hold), so nothing is
    gathered."""
    mesh = cache.device_mesh
    lay = cache.placements
    seq = _seq_dims(cache)
    block, n = mesh_block(mesh, seq)
    rows = cache.shape[1] // n
    lo = block * rows

    def write(local, upd):
        at = torch.arange(pos, pos + upd.shape[1], device=local.device) - lo
        mine = (at >= 0) & (at < rows)
        at = at.clamp(0, rows - 1)
        keep = local.index_select(1, at)
        shape = (1, -1) + (1,) * (local.dim() - 2)
        local.index_copy_(1, at, torch.where(mine.view(shape), upd, keep))
        return local

    new_lay = [Replicate() if i in seq else p for i, p in enumerate(lay)]
    local_map(write, out_placements=list(lay), in_placements=(lay, new_lay),
              device_mesh=mesh, redistribute_inputs=True)(cache, new)


def decode_attention(scores_of, context_of, queries: tuple, keys: tuple,
                     pos: int, S: int, scale: float, dtype):
    """Causal decode attention over a cache whose sequence may be sharded:
    ``scores_of(*queries, *keys)`` gives a rank's scores ``[..., S,
    rows]`` against its block of the cache, ``context_of(p, *keys)`` the
    context of its (normalised) probabilities.  The softmax's max and sum
    and the context are reduced over the sequence's ranks (flash-decoding);
    the queries are laid out as the cache's batch, replicated over the
    sequence's ranks.  Returns the context in the queries' layout."""
    mesh = keys[0].device_mesh
    lay = list(keys[0].placements)
    seq = _seq_dims(keys[0])
    block, n = mesh_block(mesh, seq)
    rows = keys[0].shape[1] // n
    lo = block * rows
    groups = [mesh.get_group(i) for i in seq]
    q_lay = [Replicate() if i in seq else p for i, p in enumerate(lay)]

    def local(*t):
        qs, ks = t[:len(queries)], t[len(queries):]
        kv_pos = lo + torch.arange(rows, device=ks[0].device)
        mask = kv_pos[None, :] <= (pos + torch.arange(S, device=ks[0]
                                                       .device))[:, None]
        s = scores_of(*qs, *ks).float() * scale
        s = s.masked_fill(~mask, _m.NEG)
        mx = s.amax(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(s - mx)
        tot = e.sum(-1, keepdim=True)
        for g in groups:
            dist.all_reduce(tot, group=g)
        ctx = context_of((e / tot).to(dtype), *ks)
        for g in groups:
            dist.all_reduce(ctx, group=g)
        return ctx

    return local_map(local, out_placements=q_lay,
                     in_placements=tuple([q_lay] * len(queries))
                     + tuple([lay] * len(keys)), device_mesh=mesh,
                     redistribute_inputs=True)(*queries, *keys)


def gqa_decode(q, ck, cv, pos: int, scale: float):
    """``model._gqa_scores_ctx`` of decode's queries ``q [B, S, H, Dh]``
    against a (sequence-sharded) cache ``ck``/``cv [B, Smax, Hkv, Dh]``."""
    B, S, H, Dh = q.shape
    Hkv = ck.shape[2]

    def scores(ql, kl, vl):
        qg = ql.reshape(ql.shape[0], S, Hkv, H // Hkv, Dh)
        return torch.einsum("bqhrd,bkhd->bhrqk", qg, kl)

    def context(p, kl, vl):
        ctx = torch.einsum("bhrqk,bkhd->bqhrd", p, vl)
        return ctx.reshape(ctx.shape[0], S, H, vl.shape[-1])

    return decode_attention(scores, context, (q,), (ck, cv), pos, S, scale,
                            q.dtype)


def mla_decode(q_abs, q_pe, cc, cpe, pos: int, scale: float):
    """MLA's absorbed decode attention (``model.mla_attend``): latent
    queries ``q_abs [B, S, H, r]`` and rotary ``q_pe [B, S, H, dr]``
    against the latent cache ``cc [B, Smax, r]`` and ``cpe [B, Smax,
    dr]``; returns the latent context ``[B, S, H, r]``."""
    S = q_abs.shape[1]

    def scores(qa, qp, c, pe):
        return torch.einsum("bshr,btr->bhst", qa, c) \
            + torch.einsum("bshk,btk->bhst", qp, pe)

    def context(p, c, pe):
        return torch.einsum("bhst,btr->bshr", p, c)

    return decode_attention(scores, context, (q_abs, q_pe), (cc, cpe), pos,
                            S, scale, q_abs.dtype)


def microbatches(tokens, n: int) -> list:
    """``tokens [B, S]`` as ``n`` microbatches of ``B / n`` rows, each in
    the batch's layout (``model.forward`` pins it): the batch's shards are
    gathered first (int64 tokens, small), since microbatch ``i`` spans
    several ranks' rows."""
    rep = gathered(tokens, [Replicate()] * tokens.device_mesh.ndim)
    return list(rep.reshape(n, tokens.shape[0] // n, -1).unbind(0))
