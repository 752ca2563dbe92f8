from nbody_sim.models.gnn import GraphModel
from nbody_sim.models.contconv import ContinuousConvModel
from nbody_sim.models.mlp import MLP

__all__ = ["GraphModel", "ContinuousConvModel", "MLP"]
