"""Unified dataclass config tree + CLI overrides (SURVEY.md §5.6).

The reference's configuration surface is split between an argparse datagen CLI
(``s01-dataset-generation.py:12-91``) and hard-coded experiment scripts
(``gnn_experiment.py:61-90``). Here one JSON-serialisable tree covers datagen,
model, and training, with dotted-path CLI overrides:

    python -m nbody_sim.experiments.run --config exp.json \
        --set train.epochs=20 --set model.kwargs.gnn_dim=128
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from nbody_sim.data.generate import ScenarioConfig


@dataclasses.dataclass
class DatagenConfig:
    """Fan-out datagen parameters; list-valued fields take the cartesian
    product (s01:93-104)."""

    n_bodies: Any = dataclasses.field(default_factory=lambda: [3, 25, 50, 100, 250, 500])
    integrator: str = "leapfrog"
    sim_type: Any = "spiral"
    steps: int = 1000
    dt: float = 1e-4
    softening: float = 0.05
    g: float = 4.5e-6
    total_mass: float = 1.0
    radial_scale: float = 3.0
    height_scale: float = 0.3
    black_hole_mass: float = 0.01
    n_arms: int = 2
    pitch_angle: float = -0.5235987755982988
    arm_strength: float = 0.3
    train_files: int = 10
    test_files: int = 1
    seed: Optional[int] = None
    force_backend: str = "auto"  # "dense" | "pallas" | "bh" | "bh2" | "auto"
    bh_near: int = 32  # bh/bh2 ground-truth accuracy knob
    bh_refresh: int = 1  # bh/bh2 partition refresh interval


@dataclasses.dataclass
class ModelConfig:
    """``type`` picks the surrogate family; ``kwargs`` feed its flax ctor."""

    type: str = "gnn"  # "gnn" | "contconv"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 64
    learning_rate: float = 0.01
    save_every: int = 10
    dt: float = 1e-4
    sim_steps: int = 1000
    scheduler_factor: float = 0.1
    scheduler_patience: int = 10
    seed: int = 0
    merge_files: bool = False  # pool every file's snapshots (adopted
    # contconv recipe, run_experiments.sh)
    batch_mode: str = "bucketed"  # "bucketed" | "mixed" | "reference"
    # (Trainer.train_from_dir batch composition)


@dataclasses.dataclass
class ExperimentConfig:
    name: str = "gnn"
    base: str = "."
    datagen: DatagenConfig = dataclasses.field(default_factory=DatagenConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    # ------------------------------------------------------------ plumbing
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        return cls(
            name=d.get("name", "gnn"),
            base=d.get("base", "."),
            datagen=DatagenConfig(**d.get("datagen", {})),
            model=ModelConfig(**d.get("model", {})),
            train=TrainConfig(**d.get("train", {})),
        )

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def apply_overrides(self, overrides: List[str]) -> "ExperimentConfig":
        """Apply ``a.b.c=value`` overrides (values parsed as JSON, falling
        back to raw strings)."""
        d = self.to_dict()
        for ov in overrides:
            key, _, raw = ov.partition("=")
            if not _:
                raise ValueError(f"override {ov!r} must look like path=value")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        return ExperimentConfig.from_dict(d)

    # ------------------------------------------------------------- factories
    def build_model(self):
        from nbody_sim.models import ContinuousConvModel, GraphModel

        kw = dict(self.model.kwargs)
        for k, v in kw.items():  # flax ctors want hashable (tuple) sequences
            if isinstance(v, list):
                kw[k] = tuple(v)
        if self.model.type == "gnn":
            return GraphModel(**kw)
        if self.model.type == "contconv":
            return ContinuousConvModel(**kw)
        raise ValueError(f"unknown model type {self.model.type!r}")

    def scenarios(self, seed: Optional[int] = None) -> List[ScenarioConfig]:
        from nbody_sim.data.generate import scenario_product

        d = dataclasses.asdict(self.datagen)
        d.pop("train_files"), d.pop("test_files")
        if seed is not None:
            d["seed"] = seed
        return scenario_product(**d)
