from nbody_sim.ops.pairwise import pallas_accelerations
from nbody_sim.ops.treeforce import (
    BHPartition,
    BH2Partition,
    BH3Partition,
    bh_accelerations,
    bh2_accelerations,
    bh3_accelerations,
    build_bh_partition,
    build_bh2_partition,
    build_bh3_partition,
)
from nbody_sim.ops.knn import knn_neighbors, batched_knn_neighbors
from nbody_sim.ops.radius import radius_neighbors
from nbody_sim.ops.interpolate import trilinear_interpolate
from nbody_sim.ops.segment import masked_mean, masked_sum

__all__ = [
    "pallas_accelerations",
    "BHPartition",
    "BH2Partition",
    "BH3Partition",
    "bh_accelerations",
    "bh2_accelerations",
    "bh3_accelerations",
    "build_bh_partition",
    "build_bh2_partition",
    "build_bh3_partition",
    "knn_neighbors",
    "batched_knn_neighbors",
    "radius_neighbors",
    "trilinear_interpolate",
    "masked_mean",
    "masked_sum",
]
