"""Architecture registry: ``--arch <id>`` resolution for the launchers
and the dry-run.

The port runs the language models (dense GQA, MoE and MLA), DLRM-RM2,
the four GNN architectures and owner-partitioned SchNet, and holds the
reference's dry-run cells of the language models, ``deepseek-v3-opt``
and ``ripple-papers``.  The GNN, DLRM-RM2 and ``schnet-part`` modules'
``CELLS`` raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
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
    # the paper's own workload (extra, beyond the assigned cells)
    "ripple-papers": "repro_torch.configs.ripple_stream",
    "deepseek-v3-opt": "repro_torch.configs.deepseek_v3_opt",
}


def get_arch(name: str):
    """The config module of ``name``: ``CONFIG`` (published widths) and
    ``REDUCED`` (the CPU-test size) for a language model; ``CONFIG`` and
    ``SMOKE_CONFIG`` for DLRM-RM2; ``HP``, ``INIT``, ``FORWARD``,
    ``SMOKE_INIT``, ``SMOKE_FORWARD`` and ``cells()`` for a GNN; the
    capacities for ``schnet-part``; ``CELLS``, the dry-run's cells, where
    they are ported."""
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return import_module(ARCHS[name])


def cells_of(name: str):
    """The dry-run cells of ``name``, or None where they are not ported
    yet (its ``CELLS`` raises ``NotImplementedError``)."""
    try:
        return get_arch(name).CELLS
    except NotImplementedError:
        return None


def all_cells(include_extra: bool = False):
    """Every ported dry-run cell (the reference's ``all_cells``; the extra
    archs only with ``include_extra``)."""
    cells = []
    for name in ARCHS:
        if name in ("ripple-papers", "schnet-part", "deepseek-v3-opt") \
                and not include_extra:
            continue
        cells.extend(cells_of(name) or [])
    return cells
