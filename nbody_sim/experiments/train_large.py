"""Large-N surrogate training — train the GNN force surrogate on
Barnes-Hut ground truth at 10k-100k bodies, a scale the reference cannot
reach (its trainer runs at <=500 bodies on CPU, ``trainer.py:20-92``,
``gnn_experiment.py:24-49``; its only ground-truth engine is the dense
O(N^2) direct sum capped near 10^4).

Pipeline (every stage on-device):
1. datagen — spiral scenes integrated with ``force_backend='bh'``
   (``ops/treeforce.py``, M=bh-near exact blocks: ~1.8e-3 median force
   error at M=48), snapshot-strided npz-only datasets;
2. training — ``Trainer`` with Morton kNN graphs built on device inside
   the jitted step (``batch_mode='bucketed'``), per-epoch wall-clock
   recorded;
3. eval — stepwise loss on a held-out scene, then an autoregressive
   rollout from its step-0 state: position RMSE vs the BH ground-truth
   trajectory at every recorded snapshot AND final-state acceleration
   RMSE vs the EXACT direct-sum forces (the surrogate is graded against
   real physics, not just against its teacher).

Usage:
    python -m nbody_sim.experiments.train_large --n-bodies 20000 \
        --train-scenes 2 --steps 400 --stride 4 --epochs 10

Writes ``results/large_scale/train_<N>.json`` + an epoch-loss CSV.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

G, EPS, DT = 4.5e-6, 0.05, 1e-4


def main(argv=None):
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    p = argparse.ArgumentParser()
    p.add_argument("--model", default="gnn", choices=["gnn", "contconv"],
                   help="surrogate family")
    p.add_argument("--n-bodies", type=int, default=20_000)
    p.add_argument("--train-scenes", type=int, default=2)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--bh-near", type=int, default=48)
    p.add_argument("--bh-refresh", type=int, default=4)
    p.add_argument("--time-chunks", type=int, default=1,
                   help="run datagen as C sequential scan chunks — the "
                        "full-trajectory device-memory footprint scales "
                        "with the longest single scan")
    p.add_argument("--epochs", type=int, default=10,
                   help="epochs to run in THIS invocation — with "
                        "--save-every, a relaunched run resumes from the "
                        "latest checkpoint and runs this many MORE epochs "
                        "(the epoch-loss CSV keeps the pre-resume rows)")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--neighbors", type=int, default=10)
    p.add_argument("--gnn-dim", type=int, default=64)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize EdgeConv layers in the backward "
                        "pass — required to fit 1M-body GNN training on "
                        "one chip (see GraphModel.remat)")
    p.add_argument("--zero-init-output", action="store_true",
                   help="zero-init the output head: the net starts at "
                        "pred=0 (relative error 1.0) instead of O(1e-2) "
                        "noise that dwarfs the ~1e-7-magnitude targets")
    p.add_argument("--output-scale", type=float, default=1e6,
                   help="net predicts y*scale and divides it out "
                        "(models/gnn.py output_scale): Adam's scale-free "
                        "steps cannot hold the ~1e-9 weight magnitudes raw "
                        "1e-7 targets need — measured 6000x worse than "
                        "predicting zero without this. 1.0 restores the "
                        "reference's raw-target semantics")
    p.add_argument("--rollout-steps", type=int, default=0,
                   help="surrogate rollout horizon for eval (0 = up to the "
                        "last recorded ground-truth snapshot)")
    p.add_argument("--graph-refresh", type=int, default=8)
    p.add_argument("--scan-chunk", type=int, default=None,
                   help="max batches per training-scan dispatch — bounds "
                        "the length of one device execution at 1M bodies, "
                        "where a whole-bucket scan runs for minutes")
    p.add_argument("--data-dir", default="results/large_scale/data")
    p.add_argument("--out", default=None)
    p.add_argument("--load-params", default=None,
                   help="skip training: load final params from this "
                        "msgpack (written by a previous run next to its "
                        "result JSON) and run the eval stages only — a "
                        "crashed eval is rerunnable without retraining")
    p.add_argument("--train-time-budget", type=float, default=0,
                   help="stop the epoch loop after this many seconds of "
                        "training wall-clock (finishing the current epoch) "
                        "so the eval ALWAYS runs, even when training would "
                        "consume the whole session; 0 = no budget")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every E epochs into <out>_ckpt/ and "
                        "resume from the latest on restart — multi-hour "
                        "1M runs must survive a timeout/worker crash "
                        "without losing their training progress")
    p.add_argument("--skip-datagen", action="store_true",
                   help="reuse existing npz datasets")
    args = p.parse_args(argv)

    from nbody_sim.data.generate import ScenarioConfig, generate_dataset, valid_npz
    from nbody_sim.data.dataset import SnapshotDataset
    from nbody_sim.models import GraphModel
    from nbody_sim.train.optim import PlateauScheduler
    from nbody_sim.train.rollout import autoregressive_rollout
    from nbody_sim.train.trainer import Trainer

    n = args.n_bodies
    tag = f"{n // 1000}k" if n % 1000 == 0 else str(n)
    data_dir = os.path.join(args.data_dir + tag)
    train_dir = os.path.join(data_dir, "train")
    test_dir = os.path.join(data_dir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)

    def scenario(seed):
        return ScenarioConfig(
            n_bodies=n, integrator="leapfrog", sim_type="spiral",
            steps=args.steps, dt=DT, softening=EPS, g=G, seed=seed,
            force_backend="bh", bh_near=args.bh_near,
            bh_refresh=args.bh_refresh,
            # exact pairwise PE per snapshot is O(N^2) — a multi-minute
            # single execution at 1M, and training never reads the energy
            # columns
            calc_energy=False,
        )

    # --- stage 1: BH ground-truth datagen -------------------------------
    t0 = time.perf_counter()
    datagen_s = 0.0
    for i in range(args.train_scenes):
        out = os.path.join(train_dir, f"train_{i}.csv")
        # Trust an existing scene only if it is a complete zip — a killed
        # datagen can leave a truncated npz that an existence-only check
        # would feed to training (BadZipFile). A corrupt scene is regenerated (the atomic writer in
        # data/generate.py guarantees the replacement is complete).
        if args.skip_datagen and valid_npz(out[:-4] + ".npz"):
            continue
        generate_dataset([scenario(42 + i)], out, snapshot_stride=args.stride,
                         write_csv_file=False, vmap_scenes=False,
                         time_chunks=args.time_chunks)
    test_csv = os.path.join(test_dir, "test.csv")
    if not (args.skip_datagen and valid_npz(test_csv[:-4] + ".npz")):
        generate_dataset([scenario(1042)], test_csv,
                         snapshot_stride=args.stride, write_csv_file=False,
                         vmap_scenes=False, time_chunks=args.time_chunks)
    datagen_s = time.perf_counter() - t0
    print(f"datagen: {datagen_s:.1f}s", flush=True)

    # --- stage 2: train --------------------------------------------------
    if args.model == "contconv":
        from nbody_sim.models import ContinuousConvModel

        # reference recipe (contconv_experiment.py:62-76) + the large-N
        # switches: Morton radius search, output_scale
        model = ContinuousConvModel(
            in_channels=4, out_channels=3, filter_resolution=(6, 4),
            radius=1.0, agg="mean", self_loops=True,
            continuous_conv_layers=2, continuous_conv_dim=128,
            encoder_hiddens=(32, 64), decoder_hiddens=(64, 32),
            scale_factor=1e6, radius_method="morton",
            zero_init_output=args.zero_init_output,
            output_scale=args.output_scale,
        )
        rollout_model = model
    else:
        model = GraphModel(
            input_dim=4, gnn_dim=args.gnn_dim, message_passing_steps=2,
            aggr="mean", neighbors=args.neighbors, scale_factor=1e6,
            knn_method="morton",
            fused_edgeconv=True,  # the (N, k, 2d) message tensor is the memory
            # bottleneck at 20k+ bodies; same function & params
            zero_init_output=args.zero_init_output,
            output_scale=args.output_scale,
            remat=args.remat,
        )
        rollout_model = model
    trainer = Trainer(
        model, learning_rate=args.lr, dt=DT, seed=0,
        scheduler=PlateauScheduler(lr=args.lr, factor=0.25, patience=5),
    )
    mtag = "" if args.model == "gnn" else f"_{args.model}"
    out = args.out or f"results/large_scale/train_{tag}{mtag}.json"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)

    import pandas as pd

    epoch_walls = []
    last = [time.perf_counter()]
    csv_path = out[:-5] + "_epoch_loss.csv"

    def write_epoch_csv(e, losses, mses):
        # per-epoch incremental persistence: a timeout/worker crash mid-run
        # must not lose hours of 1M training evidence (the rest of the
        # artifact is rewritten from scratch after eval). `e` is the
        # trainer's resume-aware counter, so a resumed run's rows continue
        # the original numbering instead of restarting at 1 — and rows
        # below the resume epoch are merged from the existing CSV so a
        # resumed run doesn't erase the pre-crash history it protects.
        new = pd.DataFrame({"epoch": np.arange(e - len(losses) + 1, e + 1),
                            "loss": losses, "mse_loss": mses,
                            "wall_s": epoch_walls[: len(losses)]})
        first = int(new["epoch"].iloc[0])
        if first > 1 and os.path.exists(csv_path):
            old = pd.read_csv(csv_path)
            new = pd.concat([old[old["epoch"] < first], new],
                            ignore_index=True)
        new.to_csv(csv_path, index=False)

    train_t0 = time.perf_counter()

    def on_epoch(e, losses, mses):
        now = time.perf_counter()
        epoch_walls.append(now - last[0])
        last[0] = now
        write_epoch_csv(e, losses, mses)
        if args.train_time_budget and (now - train_t0) > args.train_time_budget:
            return True  # graceful stop: eval must still get its chip time

    from flax import serialization

    params_path = out[:-5] + "_params.msgpack"
    if args.load_params:
        # eval-only rerun: build the param template from one batch, then
        # overwrite with the committed weights
        from nbody_sim.data.dataset import BatchIterator
        from nbody_sim.train.trainer import _list_dataset_files

        first_ds = SnapshotDataset.from_file(_list_dataset_files(train_dir)[0])
        first_batch = next(iter(
            BatchIterator(first_ds, args.batch_size, shuffle=False)))
        trainer._ensure_state(first_batch)
        with open(args.load_params, "rb") as f:
            loaded = serialization.from_bytes(
                {"params": trainer.state.params}, f.read())
        trainer.state = trainer.state.replace(params=loaded["params"])
        losses, mses = [float("nan")], [float("nan")]
        train_s = 0.0
        print(f"loaded params from {args.load_params}", flush=True)
    else:
        t0 = time.perf_counter()
        losses, mses = trainer.train_from_dir(
            train_dir, epochs=args.epochs, batch_size=args.batch_size,
            batch_mode="bucketed", verbose=True, on_epoch_end=on_epoch,
            scan_chunk=args.scan_chunk,
            save_every=args.save_every,
            save_path=(out[:-5] + "_ckpt") if args.save_every else None,
        )
        train_s = time.perf_counter() - t0
        print(f"train: {train_s:.1f}s, final loss {losses[-1]:.4f}",
              flush=True)

        # durable weights, FIRST thing after training: checkpoints live in a
        # gitignored Orbax dir that a machine wipe destroys — the final params are O(100 KB) for the GNN and belong next
        # to the result JSON so a crashed eval can be rerun without retraining
        with open(params_path + ".tmp", "wb") as f:
            f.write(serialization.to_bytes({"params": trainer.state.params}))
        os.replace(params_path + ".tmp", params_path)
        print(f"wrote {params_path} "
              f"({os.path.getsize(params_path) / 1024:.0f} KiB)", flush=True)

    # free the device-resident training buckets before eval: at 1M bodies
    # they hold ~8 GB of device memory (2 scenes x 100 x (1M, 7+3) f32)
    trainer._dev_cache.clear()
    trainer._ds_cache.clear()

    # --- stage 3: eval ---------------------------------------------------
    test_ds = SnapshotDataset.from_file(test_csv)
    traj = test_ds.scene_trajectory(0)
    step_idx = np.sort(
        np.asarray(test_ds.buckets[n].step[test_ds.buckets[n].scene == 0]))

    # stepwise: 1-step scaled RMSE over all recorded test snapshots
    # (reference loss semantics, gnn.py:150-161)
    from nbody_sim.train.graphs import build_graph

    variables = {"params": trainer.state.params}
    if trainer._has_bn:
        variables["batch_stats"] = trainer.state.batch_stats

    @jax.jit
    def stepwise_loss(x, y):
        idx, valid = build_graph(model.graph_spec, x[..., :3])
        pred = model.apply(variables, x, idx, valid, train=False)
        return jnp.sqrt(jnp.mean((model.scale_factor * (pred - y)) ** 2))

    b = test_ds.buckets[n]
    sw = []
    for i in range(b.x.shape[0]):
        sw.append(float(stepwise_loss(b.x[i][None], b.y[i][None])))
    stepwise = float(np.mean(sw))
    # the honesty baseline: a model that predicts zero scores exactly
    # scale_factor * rms(y) on this loss — anything above it learned
    # nothing (or worse); see GraphModel.output_scale on the raw-target
    # pathology
    zero_baseline = float(
        model.scale_factor * np.sqrt((np.asarray(b.y) ** 2).mean()))
    print(f"stepwise scaled RMSE: {stepwise:.4f} "
          f"(predict-zero baseline {zero_baseline:.4f})", flush=True)

    # persist training + stepwise results BEFORE the rollout: a rollout
    # failure (OOM/worker crash at large N) must not lose a half-hour of
    # training evidence
    if args.load_params and os.path.exists(out):
        # eval-only rerun: keep the original run's training record
        with open(out) as f:
            prior_training = json.load(f).get("training")
    else:
        prior_training = None
    result = {
        "n_bodies": n,
        "model": args.model,
        "device": jax.devices()[0].platform,
        "dataset": {
            "train_scenes": args.train_scenes, "steps": args.steps,
            "stride": args.stride, "bh_near": args.bh_near,
            "datagen_seconds": round(datagen_s, 1),
            "snapshots_per_scene": int(np.ceil(args.steps / args.stride)),
        },
        "training": {
            "epochs": args.epochs, "batch_size": args.batch_size,
            "lr": args.lr, "output_scale": args.output_scale,
            "neighbors": args.neighbors, "scan_chunk": args.scan_chunk,
            "remat": bool(args.remat),
            "final_scaled_rmse": losses[-1],
            "first_scaled_rmse": losses[0],
            "seconds_total": round(train_s, 1),
            "seconds_per_epoch": [round(w, 2) for w in epoch_walls],
        },
        "eval": {
            "stepwise_scaled_rmse": stepwise,
            "predict_zero_baseline_scaled_rmse": zero_baseline,
        },
    }
    if prior_training is not None:
        result["training"] = prior_training
        result["eval"]["params_loaded_from"] = args.load_params
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    if not args.load_params:
        write_epoch_csv(trainer.epoch, losses, mses)
    print(f"wrote {out} (pre-rollout)", flush=True)

    # rollout vs BH ground truth + exact forces
    horizon = args.rollout_steps or int(step_idx[-1])
    pos0 = jnp.asarray(traj.pos[0])
    vel0 = jnp.asarray(traj.vel[0])
    mass = jnp.asarray(traj.mass)
    t0 = time.perf_counter()
    ps, vs, accs = autoregressive_rollout(
        rollout_model, variables, pos0, vel0, mass,
        horizon + 1, DT, graph_refresh=args.graph_refresh,
    )
    ps_np = np.asarray(ps)
    rollout_s = time.perf_counter() - t0

    rows = []
    for j, s in enumerate(step_idx):
        if s > horizon:
            break
        rmse = float(np.sqrt(
            ((ps_np[int(s)] - traj.pos[j]) ** 2).sum(-1).mean()))
        rows.append({"step": int(s), "pos_rmse": rmse})

    # final-state force fidelity vs the EXACT direct sum
    from nbody_sim.core.simulate import SimulationConfig, make_acc_fn

    force_fn = make_acc_fn(mass, SimulationConfig(g_const=G, softening=EPS))
    a_exact = np.asarray(
        jax.jit(force_fn)(jnp.asarray(ps_np[horizon]))
    )
    a_pred = np.asarray(accs[-1])
    num = np.linalg.norm(a_pred - a_exact, axis=1)
    den = np.maximum(np.linalg.norm(a_exact, axis=1), 1e-30)
    acc_med = float(np.median(num / den))
    acc_rmse = float(np.sqrt((num ** 2).mean()))
    # global relative error — |a| is heavy-tailed (hot galactic center,
    # cold outskirts), so the per-particle median punishes noise at tiny
    # |a| rows; error relative to the field's own RMS is the fair scalar
    acc_rel_rmse = float(acc_rmse / np.sqrt((a_exact ** 2).mean()))

    result["eval"].update({
        "rollout_horizon": horizon,
        "rollout_seconds": round(rollout_s, 2),
        "rollout_pos_rmse": rows,
        "final_acc_median_rel_err_vs_exact": acc_med,
        "final_acc_rmse_vs_exact": acc_rmse,
        "final_acc_rel_rmse_vs_exact": acc_rel_rmse,
    })
    print(json.dumps({"final_loss": losses[-1], "stepwise": stepwise,
                      "zero_baseline": zero_baseline,
                      "final_pos_rmse": rows[-1]["pos_rmse"] if rows else None,
                      "acc_med_rel_err": acc_med,
                      "acc_rel_rmse": acc_rel_rmse}), flush=True)

    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
