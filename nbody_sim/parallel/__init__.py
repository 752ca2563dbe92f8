from nbody_sim.parallel.bh import (bh2_simulate, bh3_simulate, bh_simulate,
                                   sharded_bh_accelerations,
                                   sharded_bh2_accelerations,
                                   sharded_bh3_accelerations)
from nbody_sim.parallel.mesh import make_mesh, particle_sharding
from nbody_sim.parallel.ring import ring_accelerations, ring_simulate

_SURROGATE = (
    "sharded_contconv_loss_and_grad",
    "sharded_contconv_predict",
    "sharded_contconv_rollout",
    "sharded_loss_and_grad",
    "sharded_predict",
    "sharded_rollout",
)


def __getattr__(name):
    # the sharded surrogate needs flax; the physics paths above must not
    if name in _SURROGATE:
        from nbody_sim.parallel import surrogate

        return getattr(surrogate, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "bh2_simulate",
    "bh3_simulate",
    "bh_simulate",
    "make_mesh",
    "particle_sharding",
    "ring_accelerations",
    "ring_simulate",
    "sharded_bh_accelerations",
    "sharded_bh2_accelerations",
    "sharded_bh3_accelerations",
    "sharded_contconv_loss_and_grad",
    "sharded_contconv_predict",
    "sharded_contconv_rollout",
    "sharded_loss_and_grad",
    "sharded_predict",
    "sharded_rollout",
]
