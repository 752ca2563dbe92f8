"""Generic config-driven experiment runner:

    python -m nbody_sim.experiments.run --config exp.json \
        --set train.epochs=20 --set model.kwargs.gnn_dim=128

Covers the full pipeline: datagen (skipped when data exists) -> train ->
stepwise + rollout eval -> results CSVs, all from one
:class:`nbody_sim.config.ExperimentConfig` tree. The two reference-parity
drivers (``gnn_experiment``/``contconv_experiment``) are fixed instances of
this flow.
"""

from __future__ import annotations

import argparse
import os
import random

import pandas as pd

from nbody_sim.config import ExperimentConfig
from nbody_sim.data.generate import generate_dataset
from nbody_sim.experiments.common import setup_dirs
from nbody_sim.train import PlateauScheduler, Trainer


def run(cfg: ExperimentConfig) -> None:
    paths = setup_dirs(cfg.name, cfg.base)
    cfg.save(os.path.join(paths["results"], "config.json"))

    rng = random.Random(cfg.datagen.seed)
    for split, count in (("train", cfg.datagen.train_files),
                         ("test", cfg.datagen.test_files)):
        out_dir = paths[split]
        if os.listdir(out_dir):
            continue
        for i in range(1, count + 1):
            generate_dataset(
                cfg.scenarios(seed=rng.randint(0, 1000)),
                os.path.join(out_dir, f"output_file_{i}.csv"),
            )

    model = cfg.build_model()
    scheduler = PlateauScheduler(
        lr=cfg.train.learning_rate,
        factor=cfg.train.scheduler_factor,
        patience=cfg.train.scheduler_patience,
    )
    trainer = Trainer(
        model,
        learning_rate=cfg.train.learning_rate,
        scheduler=scheduler,
        dt=cfg.train.dt,
        seed=cfg.train.seed,
    )

    loss_csv = os.path.join(paths["results"], "epoch_loss.csv")
    epoch_loss, _ = trainer.train_from_dir(
        data_path=paths["train"],
        epochs=cfg.train.epochs,
        batch_size=cfg.train.batch_size,
        save_every=cfg.train.save_every,
        save_path=paths["weights"],
        on_epoch_end=lambda e, losses, mses: pd.DataFrame(
            losses, columns=["loss"]
        ).to_csv(loss_csv, index=False),
        merge_files=cfg.train.merge_files,
        batch_mode=cfg.train.batch_mode,
    )

    df_stepwise, df_rollout = trainer.test_from_dir(
        data_path=paths["test"],
        model_path=paths["weights"],
        sim_steps=cfg.train.sim_steps,
    )
    df_stepwise.to_csv(
        os.path.join(paths["results"], "test_results_stepwise.csv"), index=True
    )
    df_rollout[["pos_rmse", "vel_rmse", "acc_rmse"]].to_csv(
        os.path.join(paths["results"], "test_results_rollout.csv"), index=True
    )
    print(f"results saved under {paths['results']}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="JSON ExperimentConfig")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE", help="dotted-path override")
    args = p.parse_args(argv)
    cfg = ExperimentConfig.load(args.config) if args.config else ExperimentConfig()
    cfg = cfg.apply_overrides(args.overrides)
    run(cfg)


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
