"""Architecture registry: ``--arch <id>`` resolution for the launchers.

The port serves the dense-GQA language models.  Every other arch of
``repro``'s registry raises ``NotImplementedError`` naming the ROADMAP item
that ports it, so no name is ever served by something else.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

_MOE_MLA = "MoE / MLA language models: ROADMAP.md Queue 1, item 5"
_GNN = "GNN models (models/gnn): ROADMAP.md Queue 1, item 5"
NOT_PORTED = {
    "olmoe-1b-7b": _MOE_MLA,
    "deepseek-v3-671b": _MOE_MLA,
    "deepseek-v3-opt": _MOE_MLA,
    "schnet": _GNN,
    "pna": _GNN,
    "nequip": _GNN,
    "dimenet": _GNN,
    "schnet-part": _GNN,
    "dlrm-rm2": "recsys models (models/recsys): ROADMAP.md Queue 1, item 5",
    "ripple-papers": "the distributed dry-run cell (launch/dryrun.py): "
                     "ROADMAP.md Queue 1, items 4 and 5",
}


def get_arch(name: str):
    """The config module of ``name``: ``CONFIG`` (published widths) and
    ``REDUCED`` (the CPU-test size)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return import_module(ARCHS[name])
