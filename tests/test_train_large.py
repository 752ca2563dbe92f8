"""Smoke tests for the large-N training experiment driver
(``experiments/train_large.py``): the full datagen -> train -> stepwise +
rollout eval pipeline at toy size, for both surrogate families. Pins the
artifact schema (predict-zero baseline, global rel-RMSE) and that training
with ``output_scale`` produces finite, sub-baseline-or-close losses."""

import json

import pytest

from nbody_sim.experiments.train_large import main as train_large_main


@pytest.mark.parametrize("model", ["gnn", "contconv"])
def test_train_large_pipeline_smoke(model, tmp_path):
    out = tmp_path / f"train_{model}.json"
    train_large_main([
        "--model", model,
        "--n-bodies", "192",
        "--train-scenes", "1",
        "--steps", "24",
        "--stride", "8",
        "--bh-near", "2",
        "--epochs", "2",
        "--batch-size", "1",
        "--zero-init-output",
        "--graph-refresh", "4",
        "--data-dir", str(tmp_path / "data"),
        "--out", str(out),
    ])
    result = json.loads(out.read_text())
    assert result["model"] == model
    tr, ev = result["training"], result["eval"]
    assert tr["output_scale"] == 1e6
    # finite, recorded, and self-auditing
    assert tr["final_scaled_rmse"] == tr["final_scaled_rmse"]  # not NaN
    assert ev["predict_zero_baseline_scaled_rmse"] > 0
    assert ev["final_acc_rel_rmse_vs_exact"] == ev["final_acc_rel_rmse_vs_exact"]
    assert len(ev["rollout_pos_rmse"]) >= 1
    # with zero-init + output_scale the model starts AT the zero baseline;
    # two epochs must not blow it up by orders of magnitude (the raw-target
    # pathology this driver exists to avoid)
    assert tr["final_scaled_rmse"] < 10 * ev["predict_zero_baseline_scaled_rmse"]
