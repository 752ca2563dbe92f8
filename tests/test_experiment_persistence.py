"""Crash-safe artifact persistence in the experiment drivers.

The 1M-scale runs lean on two invariants:

* ``train_large``'s per-epoch loss CSV must keep pre-resume rows when a
  checkpointed run is relaunched — it exists precisely to preserve
  multi-hour training evidence across crashes.
* ``crossover``'s incremental per-row rewrite must merge with an existing
  artifact even without ``--only`` — a mid-sweep crash must never shrink
  previously committed rows.
"""

import json
import os

import numpy as np
import pandas as pd
import pytest


@pytest.fixture()
def work(tmp_path):
    return str(tmp_path)


def test_train_large_epoch_csv_survives_resume(work):
    from nbody_sim.experiments import train_large

    out = os.path.join(work, "train_256.json")
    common = ["--model", "gnn", "--n-bodies", "256", "--train-scenes", "1",
              "--steps", "6", "--stride", "1", "--neighbors", "4",
              "--batch-size", "2", "--rollout-steps", "2",
              "--scan-chunk", "2", "--save-every", "1",
              "--data-dir", os.path.join(work, "data_"), "--out", out]
    train_large.main(common + ["--epochs", "2"])
    csv = out[:-5] + "_epoch_loss.csv"
    df1 = pd.read_csv(csv)
    assert list(df1["epoch"]) == [1, 2]

    # relaunch with the same ckpt dir: resumes at epoch 2, runs 2 MORE
    # (per-invocation --epochs semantics) and must KEEP rows 1-2
    train_large.main(common + ["--epochs", "2", "--skip-datagen"])
    df2 = pd.read_csv(csv)
    assert list(df2["epoch"]) == [1, 2, 3, 4]
    assert np.allclose(df2["loss"][:2], df1["loss"])


def test_crossover_incremental_merge_without_only(work, monkeypatch):
    from nbody_sim.experiments import crossover

    # the measurement legs run at device scale; stub them so the CPU run
    # drives main()'s real row/merge/persistence logic only
    monkeypatch.setattr(
        crossover, "simulate", lambda pos, vel, mass, steps, cfg: pos)
    monkeypatch.setattr(
        crossover, "autoregressive_rollout",
        lambda model, variables, pos, vel, mass, steps, dt, graph_refresh:
        pos)

    out = os.path.join(work, "crossover.json")
    args = ["--steps", "2", "--neighbors", "4", "--graph-refresh", "1",
            "--out", out]
    crossover.main(["--n-bodies", "256"] + args)
    rows1 = json.load(open(out))["rows"]

    # a second sweep at a different n must keep the first sweep's rows
    crossover.main(["--n-bodies", "512"] + args)
    rows2 = json.load(open(out))["rows"]
    assert {r["n"] for r in rows2} == {256, 512}
    assert len(rows2) == 2 * len(rows1)

    # and re-measuring the same n replaces rows instead of duplicating
    crossover.main(["--n-bodies", "256"] + args)
    rows3 = json.load(open(out))["rows"]
    assert len(rows3) == len(rows2)
