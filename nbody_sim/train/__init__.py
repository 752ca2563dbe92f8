from nbody_sim.train.trainer import Trainer
from nbody_sim.train.elastic import (ElasticResult, TrainingFault, all_finite,
                                     elastic_train)
from nbody_sim.train.optim import PlateauScheduler, make_optimizer
from nbody_sim.train.rollout import autoregressive_rollout, predict_accelerations

__all__ = [
    "Trainer",
    "ElasticResult",
    "TrainingFault",
    "all_finite",
    "elastic_train",
    "PlateauScheduler",
    "make_optimizer",
    "autoregressive_rollout",
    "predict_accelerations",
]
