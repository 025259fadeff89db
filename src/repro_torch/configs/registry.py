"""Architecture registry: ``--arch <id>`` resolution for the launchers.

The port runs the language models (dense GQA, MoE and MLA), DLRM-RM2,
the four GNN architectures and owner-partitioned SchNet.  The two archs
of ``repro``'s registry that exist only for its dry run raise
``NotImplementedError`` naming the ROADMAP item that ports them, so no
name is ever served by something else.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "schnet": "repro_torch.configs.schnet",
    "pna": "repro_torch.configs.pna",
    "nequip": "repro_torch.configs.nequip",
    "dimenet": "repro_torch.configs.dimenet",
    "schnet-part": "repro_torch.configs.schnet_part",
}

_DRYRUN = ("the dry-run cells (launch/dryrun.py): ROADMAP.md Queue 1, "
           "item 5.3")
NOT_PORTED = {
    "deepseek-v3-opt": "its variants change only the GSPMD shardings and "
                       "the train microbatch; " + _DRYRUN,
    "ripple-papers": "the distributed dry-run cell (launch/dryrun.py): "
                     "ROADMAP.md Queue 1, item 5.3",
}


def get_arch(name: str):
    """The config module of ``name``: ``CONFIG`` (published widths) and
    ``REDUCED`` (the CPU-test size) for a language model; ``CONFIG`` and
    ``SMOKE_CONFIG`` for DLRM-RM2; ``HP``, ``INIT``, ``FORWARD``,
    ``SMOKE_INIT``, ``SMOKE_FORWARD`` and ``cells()`` for a GNN; the
    capacities for ``schnet-part``."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{NOT_PORTED[name]}")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return import_module(ARCHS[name])
