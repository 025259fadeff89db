"""Architecture registry: ``--arch <id>`` resolution for the launchers
and the dry-run.

The port runs the language models (dense GQA, MoE and MLA), DLRM-RM2,
the four GNN architectures and owner-partitioned SchNet, and every arch
holds its dry-run ``CELLS``, the reference's: the 40 assigned cells (the
five language models', the four GNNs' and DLRM-RM2's) and the extra
ones of ``ripple-papers``, ``schnet-part`` and ``deepseek-v3-opt``.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "schnet": "repro_torch.configs.schnet",
    "pna": "repro_torch.configs.pna",
    "nequip": "repro_torch.configs.nequip",
    "dimenet": "repro_torch.configs.dimenet",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    # the paper's own workload (extra, beyond the assigned 40 cells)
    "ripple-papers": "repro_torch.configs.ripple_stream",
    # the optimised variants (extra)
    "schnet-part": "repro_torch.configs.schnet_part",
    "deepseek-v3-opt": "repro_torch.configs.deepseek_v3_opt",
}


def get_arch(name: str):
    """The config module of ``name``: ``CONFIG`` (published widths) and
    ``REDUCED`` (the CPU-test size) for a language model; ``CONFIG`` and
    ``SMOKE_CONFIG`` for DLRM-RM2; ``HP``, ``INIT``, ``FORWARD``,
    ``SMOKE_INIT``, ``SMOKE_FORWARD`` and ``cells()`` (materialised) for
    a GNN; the capacities for ``schnet-part``; and ``CELLS``, the
    dry-run's cells, for every arch."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return import_module(ARCHS[name])


def all_cells(include_extra: bool = False):
    """The reference's ``all_cells``: the 40 assigned cells in registry
    order, and the extra archs' with ``include_extra``."""
    cells = []
    for name in ARCHS:
        if name in ("ripple-papers", "schnet-part", "deepseek-v3-opt") \
                and not include_extra:
            continue
        cells.extend(get_arch(name).CELLS)
    return cells
