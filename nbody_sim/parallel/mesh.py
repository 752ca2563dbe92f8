"""Device-mesh helpers.

The reference is strictly single-device (``simulation.py:46-51``); scaling in
this framework happens through ``jax.sharding.Mesh`` + ``shard_map`` with XLA
collectives (SURVEY.md §2.9b). The mesh is flat: on a GPU host every card
reaches every other at the same rate over NVLink, so the shape follows the
algorithm alone. Two mesh axes are used across the framework:

- ``"particles"`` — shards the particle axis for the O(N^2) ring force
  (sequence-parallel analog; see ``parallel/ring.py``)
- ``"data"``      — shards training batches of snapshots (data parallel; see
  ``train/trainer.py``)
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"
DATA_AXIS = "data"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = (PARTICLE_AXIS,),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Build a 1-D (or user-shaped) mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names)


def particle_sharding(mesh: Mesh, axis: str = PARTICLE_AXIS) -> NamedSharding:
    """Sharding that splits the leading (particle) axis across the mesh."""
    return NamedSharding(mesh, P(axis))
