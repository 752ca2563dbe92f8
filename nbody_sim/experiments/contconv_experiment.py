"""ContConv experiment driver — rebuild of the reference
``contconv_experiment.py``: same datagen, ContinuousConvModel(filter res
[6, 4], radius 1.0, 2 layers x 128, encoder [32, 64], decoder [64, 32], scale
1e6) -> Adam(0.01) + default plateau -> 100 epochs, batch 16 ->
results/contconv/*.csv (contconv_experiment.py:62-113)."""

from __future__ import annotations

import argparse
import os

import pandas as pd

from nbody_sim.experiments.common import generate_data, setup_dirs
from nbody_sim.models import ContinuousConvModel
from nbody_sim.train import PlateauScheduler, Trainer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base", default=".")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--sim-steps", type=int, default=1000)
    p.add_argument("--train-files", type=int, default=10)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--merge-files", action="store_true")
    p.add_argument("--batch-mode", default="bucketed",
                   choices=["bucketed", "mixed", "reference"],
                   help="batch composition (see Trainer.train_from_dir); "
                        "'mixed' gives exact PyG DataLoader semantics incl. "
                        "union BatchNorm statistics")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--train-seed", type=int, default=0)
    p.add_argument("--check", action="store_true",
                   help="checkify NaN/Inf guard on trained parameters and "
                        "eval outputs (SURVEY.md §5.2)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="capture a jax.profiler trace of the evaluation "
                        "into DIR (SURVEY.md §5.1)")
    p.add_argument("--reference-init", action="store_true",
                   help="torch-style init for the decoder head (the default "
                        "zero-init avoids the saturation collapse)")
    args = p.parse_args(argv)

    if args.quick:
        args.epochs = min(args.epochs, 3)
        args.sim_steps = min(args.sim_steps, 50)
        args.train_files = min(args.train_files, 2)
        args.save_every = 1

    paths = setup_dirs("contconv", args.base)
    n_bodies = [3, 25] if args.quick else None
    generate_data(paths["train"], num_files=args.train_files,
                  n_bodies=n_bodies, steps=args.sim_steps, seed=args.seed)
    generate_data(paths["test"], num_files=1,
                  n_bodies=n_bodies, steps=args.sim_steps,
                  seed=None if args.seed is None else args.seed + 1)
    print("Data generated.")

    # Model config parity: contconv_experiment.py:62-76
    model = ContinuousConvModel(
        in_channels=4,
        out_channels=3,
        filter_resolution=(6, 4),
        radius=1.0,
        agg="mean",
        self_loops=True,
        continuous_conv_layers=2,
        continuous_conv_dim=128,
        encoder_hiddens=(32, 64),
        encoder_dropout=0.0,
        decoder_hiddens=(64, 32),
        scale_factor=1e6,
        zero_init_output=not args.reference_init,
    )
    scheduler = PlateauScheduler(lr=args.lr)  # torch defaults, contconv_experiment.py:79
    trainer = Trainer(model, learning_rate=args.lr, scheduler=scheduler, dt=1e-4, seed=args.train_seed)
    print("Model and trainer initialized.")

    loss_csv = os.path.join(paths["results"], "epoch_loss.csv")

    def _persist_losses(epoch, losses, mses):
        pd.DataFrame(losses, columns=["loss"]).to_csv(loss_csv, index=False)

    epoch_loss, _ = trainer.train_from_dir(
        data_path=paths["train"],
        epochs=args.epochs,
        batch_size=args.batch_size,
        save_every=args.save_every,
        save_path=paths["weights"],
        on_epoch_end=_persist_losses,
        merge_files=args.merge_files,
        batch_mode=args.batch_mode,
    )
    print("Training completed, evaluating model.")

    df_stepwise, df_rollout = trainer.test_from_dir(
        data_path=paths["test"],
        model_path=paths["weights"],
        sim_steps=args.sim_steps,
        stepwise=True,
        rollout=True,
    )
    df_stepwise.to_csv(
        os.path.join(paths["results"], "test_results_stepwise.csv"), index=True
    )
    df_rollout[["pos_rmse", "vel_rmse", "acc_rmse"]].to_csv(
        os.path.join(paths["results"], "test_results_rollout.csv"), index=True
    )
    print("Training and testing completed. Results saved.")


if __name__ == "__main__":
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    main()
