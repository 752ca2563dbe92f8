"""Shared experiment-driver plumbing (reference ``gnn_experiment.py:14-56``,
``contconv_experiment.py:14-57``): directory setup and train/test dataset
generation with the reference's scenario recipe."""

from __future__ import annotations

import os
import random
from typing import Optional

from nbody_sim.data.generate import generate_dataset, scenario_product

# The reference's datagen recipe (gnn_experiment.py:28-49): 6 spiral scenes
# per file at these body counts, 1000 leapfrog steps each.
REFERENCE_N_BODIES = [3, 25, 50, 100, 250, 500]


def generate_data(
    output_dir: str,
    num_files: int = 10,
    n_bodies=None,
    steps: int = 1000,
    seed: Optional[int] = None,
) -> None:
    """Populate ``output_dir`` with ``num_files`` trajectory CSVs, each a
    random-seeded spiral-galaxy sweep (gnn_experiment.py:24-49). Skips
    generation when the directory already has files (gnn_experiment.py:53-56).
    """
    os.makedirs(output_dir, exist_ok=True)
    if os.listdir(output_dir):
        return
    rng = random.Random(seed)
    for i in range(1, num_files + 1):
        scenarios = scenario_product(
            n_bodies=list(n_bodies or REFERENCE_N_BODIES),
            integrator="leapfrog",
            sim_type="spiral",
            steps=steps,
            n_arms=2,
            seed=rng.randint(0, 1000),
        )
        generate_dataset(
            scenarios, os.path.join(output_dir, f"output_file_{i}.csv")
        )


def setup_dirs(name: str, base: str = ".") -> dict:
    paths = {
        "train": os.path.join(base, "data", "train"),
        "test": os.path.join(base, "data", "test"),
        "weights": os.path.join(base, f"{name}_weights"),
        "results": os.path.join(base, "results", name),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    return paths
