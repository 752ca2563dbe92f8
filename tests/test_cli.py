"""CLI + config-driven runner smoke tests (tiny, CPU)."""

import os

import pytest

import numpy as np
import pandas as pd

from nbody_sim.cli.datagen import main as datagen_main
from nbody_sim.data.schema import CSV_FIELDS


def test_datagen_cli_roundtrip(tmp_path):
    out = str(tmp_path / "ds.csv")
    datagen_main(
        [
            "--integrator", "leapfrog",
            "--n-bodies", "5", "8",
            "--output", out,
            "--steps", "4",
            "--sim-type", "spiral",
            "--seed", "3",
            "--force-backend", "dense",
        ]
    )
    df = pd.read_csv(out)
    assert list(df.columns) == CSV_FIELDS
    assert len(df) == 4 * 5 + 4 * 8
    assert os.path.exists(str(tmp_path / "ds.npz"))
    assert np.isfinite(df[["x", "u", "k"]].to_numpy()).all()
    # energies identical within a (scene, step) group
    g = df.groupby(["scene", "step"])["u"].nunique()
    assert (g == 1).all()


def test_config_driven_runner(tmp_path):
    from nbody_sim.experiments.run import main as run_main

    run_main(
        [
            "--set", f"base={tmp_path}",
            "--set", "name=smoke",
            "--set", "datagen.n_bodies=[6]",
            "--set", "datagen.steps=6",
            "--set", "datagen.train_files=1",
            "--set", "datagen.seed=1",
            "--set", "train.epochs=2",
            "--set", "train.batch_size=4",
            "--set", "train.sim_steps=6",
            "--set", "train.save_every=1",
            "--set", 'model.kwargs={"input_dim": 4, "gnn_dim": 8, '
                     '"message_passing_steps": 1, "aggr": "mean", '
                     '"neighbors": 3, "scale_factor": 1e6}',
        ]
    )
    res = tmp_path / "results" / "smoke"
    for f in ["config.json", "epoch_loss.csv", "test_results_stepwise.csv",
              "test_results_rollout.csv"]:
        assert (res / f).exists(), f
    losses = pd.read_csv(res / "epoch_loss.csv")
    assert len(losses) == 2 and np.isfinite(losses["loss"]).all()


def test_datagen_time_chunks_and_check(tmp_path):
    """--time-chunks records per-chunk honest wall times (per-step step_time
    column varies); --check runs the checkify guard without tripping on a
    healthy trajectory (SURVEY.md §5.1-5.2 aux wiring)."""
    from nbody_sim.cli.datagen import main as datagen_main

    out = tmp_path / "chunked.csv"
    datagen_main([
        "--n-bodies", "8", "--integrator", "leapfrog", "--steps", "9",
        "--sim-type", "disk", "--seed", "5", "--time-chunks", "3",
        "--check", "--output", str(out),
    ])
    df = pd.read_csv(out)
    # 3 chunks of 3 steps -> at most 3 distinct step_time values, and the
    # column must be constant within each chunk
    per_step = df.groupby("step")["step_time"].first()
    assert len(per_step) == 9
    assert per_step[:3].nunique() == 1 and per_step[3:6].nunique() == 1
    npz = np.load(str(out)[:-4] + ".npz")
    assert "scene0_step_time" in npz


def test_throw_if_nonfinite_raises():
    from jax.experimental.checkify import JaxRuntimeError

    from nbody_sim.utils.debug import throw_if_nonfinite

    throw_if_nonfinite({"a": np.ones(3)}, what="ok tree")  # no raise
    with pytest.raises(JaxRuntimeError):
        throw_if_nonfinite({"a": np.array([1.0, np.nan])}, what="bad tree")


def test_datagen_cli_bh_backend(tmp_path):
    """--force-backend bh generates finite, energy-consistent trajectories
    (the treecode as a drop-in ground-truth engine for large-N datagen)."""
    out = str(tmp_path / "bh.csv")
    datagen_main(
        [
            "--integrator", "leapfrog",
            "--n-bodies", "300",
            "--output", out,
            "--steps", "3",
            "--sim-type", "disk",
            "--seed", "5",
            "--force-backend", "bh",
        ]
    )
    df = pd.read_csv(out)
    assert len(df) == 3 * 300
    assert np.isfinite(df[["x", "vx", "ax", "u", "k"]].to_numpy()).all()
