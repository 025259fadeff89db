"""The sharding strategies the dry-run registers with DTensor for ops it
has none for, in one place (:func:`register`; idempotent).  Each strategy
lives beside its op; the ones that replicate a sharded tensor are listed
in PERF.md, and the collective each causes is counted.

- ``repro_torch::flash_attention`` (the kernel's custom op):
  ``kernels/flash_attention/sharding.strategies`` -- per mesh dim, batch
  sharded, query and kv heads sharded when both head counts divide, or all
  replicated (a replicate strategy).

``repro_torch::embedding_bag`` needs none: its wrapper runs a ``DTensor``
table per shard (``kernels/embedding_bag/sharding.bag``), so the op only
ever sees one rank's local tensors; so do the GNN cells' gathers and
scatters (``models/gnn/sharded.py``, collectives written out) and DLRM's
pair pick.  The LM's own replicate rules (``models/lm/sharded.py``:
``gathered`` and its callers, ``project``'s whole layout) are layouts its
per-shard paths choose, not strategies.  Nothing else replaces a sharded
tensor by a replicated one silently: an op without a strategy or a
per-shard path stops the trace.
"""
from __future__ import annotations

_DONE: list = []


def _rules() -> dict:
    """op name -> (op, strategy function)."""
    import torch

    from repro_torch.kernels.flash_attention import sharding  # defines the op
    return {"repro_torch::flash_attention": (
        torch.ops.repro_torch.flash_attention.default, sharding.strategies)}


def register() -> None:
    """Register every strategy of :func:`_rules` with DTensor (once)."""
    if _DONE:
        return
    from torch.distributed.tensor.experimental import register_sharding
    for op, fn in _rules().values():
        register_sharding(op)(fn)
    _DONE.append(True)
