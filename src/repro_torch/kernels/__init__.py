"""Hand-written CUDA kernels for the hot path, one directory per kernel.

Each directory holds ``ref.py`` (the plain PyTorch version, the oracle the
CPU tests and the on-card checks use) and ``ops.py`` (the wrapper: the
plain version for CPU tensors, the CUDA kernel for CUDA tensors, never a
fallback).  The CUDA sources are in ``csrc/``; ``_build.py`` compiles them
with ``nvcc`` at first use.

    delta_apply  fused invertible hop apply: S' = S + M; h = act(norm(S')W + b)
    mlp_apply    fused GIN hop apply: fold + z-term + two chained products
    extremum_apply  fused monotonic hop apply: masked select, max/min fold,
                 finite-mask, product: S' = max|min(base, M);
                 h = act(finite(S')W + b)
    embedding_bag  sum-mode bag gather: out[b] = sum_h table[idx[b, h]]
                 (PNA's first moment in the bounded device hop; DLRM's
                 sparse fields)
    segment_mm   weighted CSR SpMM: out[v] = sum_(u,v) w_uv x[u] (the full
                 pass's invertible aggregation)
    flash_attention  causal grouped-query attention with an online softmax
                 (a GQA or MHA LM prefill's attention)
    shrink_pull  the monotonic hop's SHRINK pull: every needed (row, dim)
                 cell's extremum and witness re-derived from the in-CSR
"""
