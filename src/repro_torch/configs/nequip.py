"""nequip [arXiv:2101.03164]: 5 layers d_hidden=32 l_max=2 n_rbf=8 cutoff=5,
E(3) tensor-product messages (Cartesian-irrep adaptation)."""
from functools import partial

from repro_torch.models.gnn.nequip import init_nequip, nequip_forward
from .gnn_common import cell_builders, gnn_cells

HP = dict(d_hidden=32, n_layers=5, l_max=2, n_rbf=8, cutoff=5.0)
INIT = partial(init_nequip, **HP)
FORWARD = partial(nequip_forward, n_rbf=8, cutoff=5.0)
MOLECULAR, WITH_TRIPLETS, N_LAYERS = True, False, HP["n_layers"]

CELLS = gnn_cells("nequip", INIT, FORWARD, molecular=MOLECULAR,
                  d_hidden=HP["d_hidden"], n_layers=N_LAYERS)

SMOKE_INIT = partial(init_nequip, d_hidden=8, n_layers=2, l_max=2, n_rbf=4,
                     cutoff=4.0)
SMOKE_FORWARD = partial(nequip_forward, n_rbf=4, cutoff=4.0)


def cells() -> dict:
    """The four cells' materialising builders, by shape name."""
    return cell_builders("nequip", INIT, FORWARD, molecular=MOLECULAR,
                         d_hidden=HP["d_hidden"], n_layers=N_LAYERS)
