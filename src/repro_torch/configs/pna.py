"""pna [arXiv:2004.05718]: 4 layers d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation."""
from functools import partial

from repro_torch.models.gnn.pna import init_pna, pna_forward
from .gnn_common import cell_builders, gnn_cells

HP = dict(d_hidden=75, n_layers=4)
INIT = partial(init_pna, **HP)
FORWARD = partial(pna_forward, delta=2.0)
MOLECULAR, WITH_TRIPLETS, N_LAYERS = False, False, HP["n_layers"]

CELLS = gnn_cells("pna", INIT, FORWARD, molecular=MOLECULAR,
                  d_hidden=HP["d_hidden"], n_layers=N_LAYERS)

SMOKE_INIT = partial(init_pna, d_hidden=16, n_layers=2)
SMOKE_FORWARD = FORWARD


def cells() -> dict:
    """The four cells' materialising builders, by shape name."""
    return cell_builders("pna", INIT, FORWARD, molecular=MOLECULAR,
                         d_hidden=HP["d_hidden"], n_layers=N_LAYERS)
