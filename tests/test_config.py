"""Config tree: round trip, overrides, model factory."""

import json

from nbody_sim.config import ExperimentConfig
from nbody_sim.models import ContinuousConvModel, GraphModel


def test_roundtrip(tmp_path):
    cfg = ExperimentConfig(name="x")
    p = tmp_path / "c.json"
    cfg.save(str(p))
    back = ExperimentConfig.load(str(p))
    assert back.to_dict() == cfg.to_dict()


def test_overrides():
    cfg = ExperimentConfig()
    out = cfg.apply_overrides(
        ["train.epochs=7", "model.type=contconv",
         'model.kwargs.filter_resolution=[6,4]', "datagen.n_bodies=[8]",
         "name=abc"]
    )
    assert out.train.epochs == 7
    assert out.model.type == "contconv"
    assert out.model.kwargs["filter_resolution"] == [6, 4]
    assert out.datagen.n_bodies == [8]
    assert out.name == "abc"
    # original untouched
    assert cfg.train.epochs == 100


def test_build_model_and_scenarios():
    cfg = ExperimentConfig().apply_overrides(
        ["model.type=gnn", "model.kwargs.gnn_dim=32",
         "model.kwargs.neighbors=5", "datagen.n_bodies=[4,6]",
         "datagen.steps=3"]
    )
    m = cfg.build_model()
    assert isinstance(m, GraphModel) and m.gnn_dim == 32 and m.neighbors == 5

    scenarios = cfg.scenarios(seed=1)
    assert len(scenarios) == 2
    assert {s.n_bodies for s in scenarios} == {4, 6}
    assert all(s.steps == 3 and s.seed == 1 for s in scenarios)

    cfg2 = cfg.apply_overrides(
        ["model.type=contconv", 'model.kwargs={"filter_resolution": [4], "radius": 1.0}']
    )
    m2 = cfg2.build_model()
    assert isinstance(m2, ContinuousConvModel)
    assert m2.filter_resolution == (4,)  # list -> tuple for hashability


def test_committed_recipe_configs_round_trip(tmp_path):
    """The two committed recipe configs (configs/*.json) must round-trip
    through ExperimentConfig and build the exact driver models — config-runner
    parity with run_experiments.sh."""
    import json
    import os

    from nbody_sim.config import ExperimentConfig
    from nbody_sim.models import ContinuousConvModel, GraphModel

    base = os.path.join(os.path.dirname(__file__), "..", "configs")

    cfg = ExperimentConfig.load(os.path.join(base, "gnn_reference.json"))
    m = cfg.build_model()
    assert isinstance(m, GraphModel)
    assert (m.input_dim, m.gnn_dim, m.message_passing_steps, m.aggr,
            m.neighbors, m.scale_factor) == (4, 64, 2, "mean", 10, 1e6)
    assert cfg.train.batch_mode == "reference"
    assert cfg.train.learning_rate == 0.01

    cfg2 = ExperimentConfig.load(os.path.join(base, "contconv_adopted.json"))
    m2 = cfg2.build_model()
    assert isinstance(m2, ContinuousConvModel)
    assert m2.filter_resolution == (6, 4)
    assert m2.zero_init_output and m2.encoder_hiddens == (32, 64)
    assert cfg2.train.merge_files and cfg2.train.batch_mode == "mixed"
    assert cfg2.train.learning_rate == 0.001

    # save -> load round trip preserves everything
    p = tmp_path / "rt.json"
    cfg2.save(str(p))
    rt = ExperimentConfig.load(str(p))
    assert rt.to_dict() == cfg2.to_dict()

    # dotted-path overrides reach the new fields
    ov = cfg.apply_overrides(["train.batch_mode=mixed",
                              "train.merge_files=true"])
    assert ov.train.batch_mode == "mixed" and ov.train.merge_files is True
