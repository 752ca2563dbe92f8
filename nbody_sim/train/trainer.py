"""Training/eval engine — compiled rebuild of the reference ``Trainer``
(``/root/reference/trainer.py:11-344``).

Semantics parity:
- ``train_from_dir`` (trainer.py:20-92): per-epoch loop over every CSV in a
  directory, scaled-RMSE objective, plateau LR scheduling on the mean epoch
  loss, checkpoint every ``save_every`` epochs, latest-by-step resume.
- ``test_from_dir`` (trainer.py:94-200): stepwise 1-snapshot timed eval and
  sim_steps-long autoregressive rollouts, aggregated into the reference's
  result-table schemas (results/gnn/*.csv).

Differences: neighbor graphs are built on device inside the jitted
steps (not on the host at dataset load), the rollout is a single ``lax.scan``
(trainer.py:275-312 pays host syncs every step), and checkpoints carry full
training state via Orbax (the reference loses optimizer/scheduler state,
trainer.py:85-90).
"""

from __future__ import annotations

import os
from glob import glob
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import struct

from nbody_sim.data.dataset import BatchIterator, SnapshotDataset
from nbody_sim.models.common import masked_mse, scaled_rmse_and_mse
from nbody_sim.train.checkpoint import CheckpointManager
from nbody_sim.train.graphs import build_graph
from nbody_sim.train.optim import PlateauScheduler, make_optimizer
from nbody_sim.train.rollout import autoregressive_rollout
from nbody_sim.utils.timing import device_time


class TrainState(struct.PyTreeNode):
    params: Any
    batch_stats: Any  # {} when the model has no BatchNorm
    opt_state: Any


def _list_dataset_files(data_path: str):
    """Dataset files under a directory: CSVs plus npz-only datasets (large-N
    datagen with write_csv_file=False) that have no CSV sibling.
    ``SnapshotDataset.from_file`` resolves either form.

    npz-only files that are structurally corrupt (truncated by a mid-write
    kill) are excluded with a loud warning so an
    epoch loop trains on the surviving scenes instead of crashing hours in;
    CSV-backed files keep their CSV fallback in ``SnapshotDataset.from_file``."""
    from nbody_sim.data.generate import valid_npz

    files = sorted(glob(os.path.join(data_path, "*.csv")))
    stems = {f[:-4] for f in files}
    for f in sorted(glob(os.path.join(data_path, "*.npz"))):
        if f[:-4] in stems:
            continue
        if valid_npz(f):
            files.append(f)
        else:
            import warnings

            warnings.warn(
                f"skipping corrupt dataset file {f} (incomplete zip — "
                "likely a kill mid-write); regenerate it to train on it",
                stacklevel=2,
            )
    return sorted(files)


class Trainer:
    """:param model: a flax surrogate exposing ``graph_spec`` and
        ``scale_factor`` (``GraphModel`` / ``ContinuousConvModel``).
    :param learning_rate: Adam LR (gnn_experiment.py:74 uses 0.01).
    :param scheduler: optional :class:`PlateauScheduler` stepped once per
        epoch on the mean loss (trainer.py:82-83).
    :param dt: rollout timestep (trainer.py:16).
    """

    def __init__(
        self,
        model,
        learning_rate: float = 0.01,
        scheduler: Optional[PlateauScheduler] = None,
        dt: float = 0.01,
        seed: int = 0,
        mesh=None,
    ):
        """:param mesh: optional ``jax.sharding.Mesh`` with a "data" axis —
        training batches are sharded across it (data parallelism; params stay
        replicated and XLA psums the gradients). The reference is strictly
        single-device (SURVEY.md §2.9b)."""
        self.model = model
        self.dt = dt
        self.mesh = mesh
        self.tx = make_optimizer(learning_rate)
        self.scheduler = scheduler
        self.rng = jax.random.PRNGKey(seed)
        self.state: Optional[TrainState] = None
        self.epoch = 0  # resume-aware epoch counter (fixes trainer.py:38)
        self._has_bn = False
        self._ds_cache: Dict[str, SnapshotDataset] = {}
        self._dev_cache: Dict[str, dict] = {}
        self._rollout_warmed: set = set()
        self._build_steps()

    # ------------------------------------------------------------------ jit
    def _build_steps(self):
        model, tx = self.model, self.tx
        spec = model.graph_spec
        scale = model.scale_factor

        def variables_of(state: TrainState):
            v = {"params": state.params}
            if self._has_bn:
                v["batch_stats"] = state.batch_stats
            return v

        def train_step(state, x, y, mask, rng):
            idx, valid = build_graph(spec, x[..., :3], mask)

            def loss_fn(params):
                v = {"params": params}
                if self._has_bn:
                    v["batch_stats"] = state.batch_stats
                    pred, mut = model.apply(
                        v, x, idx, valid, train=True, node_mask=mask,
                        rngs={"dropout": rng}, mutable=["batch_stats"],
                    )
                else:
                    pred = model.apply(
                        v, x, idx, valid, train=True, node_mask=mask,
                        rngs={"dropout": rng},
                    )
                    mut = {}
                loss, mse = scaled_rmse_and_mse(pred, y, scale, node_mask=mask)
                return loss, (mse, mut)

            (loss, (mse, mut)), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(state.params)
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            params = optax.apply_updates(state.params, updates)
            new_bs = mut.get("batch_stats", state.batch_stats)
            return (
                state.replace(params=params, opt_state=opt_state, batch_stats=new_bs),
                loss,
                mse,
            )

        def eval_step(state, x, y, mask):
            idx, valid = build_graph(spec, x[..., :3], mask)
            pred = model.apply(
                variables_of(state), x, idx, valid, train=False, node_mask=mask
            )
            # stepwise eval uses the RAW rmse, not the scaled one (gnn.py:199)
            mse = masked_mse(pred, y, mask)
            return jnp.sqrt(mse), mse

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from nbody_sim.parallel.mesh import DATA_AXIS

            batch_sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        else:
            batch_sharding = None

        def train_step_gather(state, x_full, y_full, nv_full, sel, batch_valid, rng):
            """Device-resident batching: the whole bucket lives on device and
            each step gathers its batch by index — no per-batch host->device
            payload. ``nv_full`` holds each snapshot's real
            body count so mixed-size pools (padded to a shared N) get exact
            node masks; ``batch_valid`` rows are tail padding and enter
            neither the loss nor the BatchNorm statistics (the reference's
            partial batches are exact, trainer.py:63-65). With a mesh, the
            gathered batch is sharded across the "data" axis (dp)."""
            x = x_full[sel]
            y = y_full[sel]
            nv = nv_full[sel]
            mask = (
                jnp.arange(x_full.shape[1])[None, :] < nv[:, None]
            ) & batch_valid[:, None]
            if batch_sharding is not None:
                x = jax.lax.with_sharding_constraint(x, batch_sharding)
                y = jax.lax.with_sharding_constraint(y, batch_sharding)
                mask = jax.lax.with_sharding_constraint(mask, batch_sharding)
            return train_step(state, x, y, mask, rng)

        def eval_step_repeated(state, x, y, mask, reps: int):
            """reps timed forwards in ONE dispatch (lax.scan) so step_time
            measures device time, not per-call dispatch latency."""

            def body(carry, _):
                return carry, eval_step(state, x, y, mask)

            _, (losses, mses) = jax.lax.scan(body, 0, None, length=reps)
            return losses[-1], mses[-1]

        def train_bucket(state, x_full, y_full, nv_full, sels, valids, rngs):
            """One dispatch per (file, bucket): lax.scan over all its batches.
            Per-batch Python dispatch costs host latency on every batch even
            with device-resident data; this reduces it to ~6 dispatches per
            file."""

            def body(carry, inp):
                sel, bv, rng = inp
                new_state, loss, mse = train_step_gather(
                    carry, x_full, y_full, nv_full, sel, bv, rng
                )
                return new_state, (loss, mse)

            state, (losses, mses) = jax.lax.scan(
                body, state, (sels, valids, rngs)
            )
            return state, losses, mses

        def train_bucket_multi(state, xs, ys, nvs, sels, valids, rngs):
            """Reference batch composition (PyG DataLoader over a shuffled
            file, trainer.py:63-65): each optimizer step sees a *mixed-size*
            batch. Emulated with static shapes as one sub-batch per body-size
            bucket and a single node-weighted loss over their union:

                loss = scale * sqrt( sum_b SSE_b / sum_b 3*n_valid_b )

            which equals the reference's per-batch RMSE over all nodes of a
            mixed 64-graph batch. Gradients therefore match the reference's
            batch composition exactly for BatchNorm-free models (the GNN);
            one lax.scan per (file, epoch) over all steps.

            xs/ys/nvs: per-bucket device arrays; sels/valids: per-bucket
            (steps, quota) index/validity; rngs: (steps,) dropout keys."""

            def body(carry, inp):
                bsels, bvalids, rng = inp

                def loss_fn(params):
                    v = {"params": params}
                    if self._has_bn:
                        v["batch_stats"] = carry.batch_stats
                    sse = 0.0
                    cnt = 0.0
                    mut = {}
                    for x_full, y_full, nv_full, sel, bv in zip(
                        xs, ys, nvs, bsels, bvalids
                    ):
                        x = x_full[sel]
                        y = y_full[sel]
                        nv = nv_full[sel]
                        m = (
                            jnp.arange(x_full.shape[1])[None, :] < nv[:, None]
                        ) & bv[:, None]
                        if batch_sharding is not None:
                            # dp: each bucket's sub-batch rides the "data"
                            # axis (quotas are padded to the axis size in
                            # _train_group_reference)
                            x = jax.lax.with_sharding_constraint(
                                x, batch_sharding)
                            y = jax.lax.with_sharding_constraint(
                                y, batch_sharding)
                            m = jax.lax.with_sharding_constraint(
                                m, batch_sharding)
                        idx, valid = build_graph(spec, x[..., :3], m)
                        if self._has_bn:
                            pred, mut = model.apply(
                                v, x, idx, valid, train=True, node_mask=m,
                                rngs={"dropout": rng},
                                mutable=["batch_stats"],
                            )
                        else:
                            pred = model.apply(
                                v, x, idx, valid, train=True, node_mask=m,
                                rngs={"dropout": rng},
                            )
                        w = m.astype(pred.dtype)[..., None]
                        sse = sse + jnp.sum((pred - y) ** 2 * w)
                        cnt = cnt + jnp.sum(w) * pred.shape[-1]
                    mse = sse / jnp.maximum(cnt, 1.0)
                    loss = jnp.asarray(scale, mse.dtype) * jnp.sqrt(mse)
                    return loss, (mse, mut)

                (loss, (mse, mut)), grads = jax.value_and_grad(
                    loss_fn, has_aux=True
                )(carry.params)
                updates, opt_state = tx.update(
                    grads, carry.opt_state, carry.params
                )
                params = optax.apply_updates(carry.params, updates)
                new_bs = mut.get("batch_stats", carry.batch_stats)
                return (
                    carry.replace(
                        params=params, opt_state=opt_state, batch_stats=new_bs
                    ),
                    (loss, mse),
                )

            state, (losses, mses) = jax.lax.scan(
                body, state, (sels, valids, rngs)
            )
            return state, losses, mses

        self._train_step = jax.jit(train_step, donate_argnums=(0,))
        self._train_step_gather = jax.jit(train_step_gather, donate_argnums=(0,))
        self._train_bucket = jax.jit(train_bucket, donate_argnums=(0,))
        self._train_bucket_multi = jax.jit(
            train_bucket_multi, donate_argnums=(0,)
        )
        self._eval_step = jax.jit(eval_step)
        self._eval_step_repeated = jax.jit(
            eval_step_repeated, static_argnames=("reps",)
        )

    # ----------------------------------------------------------- state mgmt
    def _ensure_state(self, batch):
        if self.state is not None:
            return
        x = jnp.asarray(batch.x)
        idx, valid = build_graph(
            self.model.graph_spec, x[..., :3], jnp.asarray(batch.node_mask)
        )
        self.rng, init_key = jax.random.split(self.rng)
        # jit the init: eager op-by-op dispatch pays host latency per op
        variables = jax.jit(self.model.init)(init_key, x, idx, valid)
        self._has_bn = "batch_stats" in variables
        params = variables["params"]
        self.state = TrainState(
            params=params,
            batch_stats=variables.get("batch_stats", {}),
            opt_state=self.tx.init(params),
        )

    def _set_lr(self, lr: float):
        self.state.opt_state.hyperparams["learning_rate"] = jnp.asarray(
            lr, jnp.float32
        )

    def _ckpt_tree(self):
        tree = {
            "state": self.state,
            "epoch": np.asarray(self.epoch, np.int64),
            # the dropout/shuffle RNG key: without it a resumed run replays
            # a different stream and train(5)+resume(5) != train(10)
            "rng": np.asarray(self.rng),
        }
        if self.scheduler:
            tree["scheduler"] = {
                k: np.asarray(v, np.float64)
                for k, v in self.scheduler.state_dict().items()
            }
        return tree

    def _try_resume(self, save_path: str, batch) -> None:
        """Latest-by-step resume (trainer.py:38-52), incl. optimizer/scheduler."""
        self._ensure_state(batch)
        mgr = CheckpointManager(save_path)
        template = self._ckpt_tree()
        try:
            step, tree = mgr.restore_latest(template)
        except Exception:
            # checkpoints written before the RNG key joined _ckpt_tree have
            # a smaller tree; retry without it (the in-memory key stands in
            # — stream continuity is only bit-exact for new checkpoints)
            template.pop("rng")
            step, tree = mgr.restore_latest(template)
            tree["rng"] = np.asarray(self.rng)
            print("Legacy checkpoint (no RNG key): resumed with the "
                  "current in-memory key")
        if step is None:
            print("No checkpoint found")
            mgr.close()
            return
        self.state = tree["state"]
        self.epoch = int(tree["epoch"])
        self.rng = jnp.asarray(tree["rng"])
        if self.scheduler and "scheduler" in tree:
            self.scheduler.load_state_dict(
                {k: float(v) for k, v in tree["scheduler"].items()}
            )
            self._set_lr(self.scheduler.lr)
        print(f"Loaded checkpoint at epoch {self.epoch}")
        mgr.close()

    def _dataset(self, path: str) -> SnapshotDataset:
        if path not in self._ds_cache:
            self._ds_cache[path] = SnapshotDataset.from_file(path)
        return self._ds_cache[path]

    def _device_buckets(self, path: str):
        """Per-file buckets resident on device:
        {n_bodies: (x, y, n_valid) jnp arrays}."""
        if path not in self._dev_cache:
            ds = self._dataset(path)
            self._dev_cache[path] = {
                n: (
                    jnp.asarray(b.x),
                    jnp.asarray(b.y),
                    jnp.full((b.x.shape[0],), n, jnp.int32),
                )
                for n, b in ds.buckets.items()
            }
        return self._dev_cache[path]

    def _device_buckets_merged(self, paths):
        """Buckets pooled across several files, resident on device."""
        if len(paths) == 1:
            return self._device_buckets(paths[0])
        key = tuple(paths)
        if key not in self._dev_cache:
            pooled: Dict[int, list] = {}
            for p in paths:
                for n, b in self._dataset(p).buckets.items():
                    pooled.setdefault(n, []).append((b.x, b.y))
            self._dev_cache[key] = {
                n: (
                    jnp.asarray(np.concatenate([x for x, _ in parts])),
                    jnp.asarray(np.concatenate([y for _, y in parts])),
                    jnp.full(
                        (sum(x.shape[0] for x, _ in parts),), n, jnp.int32
                    ),
                )
                for n, parts in pooled.items()
            }
        return self._dev_cache[key]

    def _device_buckets_mixed(self, paths):
        """One pool of ALL snapshots padded to the shared max body count, so
        batches mix scene sizes exactly like the reference's PyG DataLoader
        (``trainer.py:63-65`` + ``datautils.py:51-53``: batch_size=64 graphs
        drawn from a shuffled file regardless of size). Returned as a single
        pseudo-bucket {max_n: (x, y, n_valid)}; the per-snapshot ``n_valid``
        yields exact node masks so padding enters neither loss nor BatchNorm."""
        key = ("mixed",) + tuple(paths)
        if key not in self._dev_cache:
            xs, ys, nvs = [], [], []
            max_n = max(
                n for p in paths for n in self._dataset(p).buckets.keys()
            )
            for p in paths:
                for n, b in self._dataset(p).buckets.items():
                    s = b.x.shape[0]
                    xs.append(
                        np.pad(b.x, ((0, 0), (0, max_n - n), (0, 0)))
                    )
                    ys.append(
                        np.pad(b.y, ((0, 0), (0, max_n - n), (0, 0)))
                    )
                    nvs.append(np.full(s, n, np.int32))
            self._dev_cache[key] = {
                max_n: (
                    jnp.asarray(np.concatenate(xs)),
                    jnp.asarray(np.concatenate(ys)),
                    jnp.asarray(np.concatenate(nvs)),
                )
            }
        return self._dev_cache[key]

    def _train_group_reference(self, group, batch_size):
        """One epoch over a file group in ``batch_mode="reference"``: every
        optimizer step takes a proportional quota of snapshots from each
        body-size bucket (each snapshot exactly once per epoch, like a
        shuffled DataLoader) and minimizes the node-weighted union loss.
        Runs as one lax.scan dispatch over all steps."""
        dev = self._device_buckets_merged(group)
        ns = sorted(dev.keys())
        xs = tuple(dev[n][0] for n in ns)
        ys = tuple(dev[n][1] for n in ns)
        nvs = tuple(dev[n][2] for n in ns)
        sizes = [x.shape[0] for x in xs]
        total = sum(sizes)
        steps = -(-total // batch_size)

        import zlib

        digest = zlib.crc32("|".join(group).encode())
        rng_np = np.random.default_rng(self.epoch * 7919 + digest % 1000)
        if self.mesh is not None:
            from nbody_sim.parallel.mesh import DATA_AXIS

            n_dev = self.mesh.shape[DATA_AXIS]
        else:
            n_dev = 1
        sels, valids = [], []
        for s in sizes:
            # pad each bucket's per-step quota to the dp axis size so the
            # sharding constraint divides evenly (pad rows are valid=False)
            q = -(-s // steps)
            q = -(-q // n_dev) * n_dev
            sel = np.zeros((steps, q), np.int32)
            val = np.zeros((steps, q), bool)
            order = rng_np.permutation(s)
            sel[np.arange(s) % steps, np.arange(s) // steps] = order
            val[np.arange(s) % steps, np.arange(s) // steps] = True
            sels.append(jnp.asarray(sel))
            valids.append(jnp.asarray(val))

        self.rng, sub = jax.random.split(self.rng)
        keys = jax.random.split(sub, steps)
        self.state, losses, mses = self._train_bucket_multi(
            self.state, xs, ys, nvs, tuple(sels), tuple(valids), keys
        )
        return [losses], [mses]

    # -------------------------------------------------------------- training
    def train_from_dir(
        self,
        data_path: str,
        epochs: int,
        batch_size: int,
        save_every: int = 0,
        save_path: Optional[str] = None,
        verbose: bool = True,
        on_epoch_end=None,
        merge_files: bool = False,
        mixed_batches: bool = False,
        batch_mode: Optional[str] = None,
        lr_scale: Optional[float] = None,
        scan_chunk: Optional[int] = None,
    ) -> Tuple[List[float], List[float]]:
        """Reference ``train_from_dir`` (trainer.py:20-92). Returns
        (epoch_losses, epoch_mse_losses) — means over all batches.

        :param on_epoch_end: optional callback
            ``(epoch, epoch_losses, epoch_mse_losses) -> None`` — e.g. for
            incremental metrics persistence.
        :param scan_chunk: cap on batches per ``_train_bucket`` dispatch
            (bucketed mode). The default single whole-bucket scan is the
            cheapest dispatch pattern, but at 1M bodies 100 batches make one
            multi-minute device execution. 8-16 keeps executions at seconds
            for pennies of extra dispatch latency.
        :param merge_files: pool every file's snapshots into shared buckets so
            batches mix scenes across files. The reference iterates one file
            at a time (trainer.py:63-65), which makes batches highly
            correlated (consecutive steps of one galaxy); merging improves
            gradient diversity. Off by default for reference parity.
        :param mixed_batches: legacy alias for ``batch_mode="mixed"``.
        :param batch_mode: how batches are composed —
            * ``"bucketed"`` (default): single-size batches per body-count
              bucket. Cheapest (no padding compute) but a different gradient
              composition than the reference.
            * ``"mixed"``: every batch drawn from ALL of a file's snapshots,
              padded to the shared max N with exact node masks — literal PyG
              DataLoader semantics (a 64-graph batch mixes 3..500-body
              scenes) at the cost of padded compute.
            * ``"reference"``: mixed-batch *gradient semantics* at bucketed
              cost — each optimizer step takes a proportional quota from
              every bucket and minimizes one node-weighted loss over their
              union, which equals the mixed-batch RMSE exactly (for
              BatchNorm-free models; with BatchNorm the batch statistics are
              per-size rather than per-union)."""
        csv_files = _list_dataset_files(data_path)
        if not csv_files:
            raise FileNotFoundError(f"no datasets under {data_path}")

        first_ds = self._dataset(csv_files[0])
        first_batch = next(iter(BatchIterator(first_ds, batch_size, shuffle=False)))
        if save_path:
            self._try_resume(save_path, first_batch)
        else:
            self._ensure_state(first_batch)
        if lr_scale is not None:
            # post-resume LR adjustment (elastic restarts back off the LR to
            # steer the re-run epoch away from the divergent trajectory)
            lr = float(self.state.opt_state.hyperparams["learning_rate"])
            if self.scheduler:
                self.scheduler.lr = lr * lr_scale
                self._set_lr(self.scheduler.lr)
            else:
                self._set_lr(lr * lr_scale)

        mgr = CheckpointManager(save_path) if (save_path and save_every > 0) else None
        epoch_losses: List[float] = []
        epoch_mse_losses: List[float] = []
        file_groups = [csv_files] if merge_files else [[f] for f in csv_files]
        mode = batch_mode or ("mixed" if mixed_batches else "bucketed")
        if mode not in ("bucketed", "mixed", "reference"):
            raise ValueError(f"unknown batch_mode {mode!r}")
        for e in range(epochs):
            losses, mses = [], []
            for group in file_groups:
                if mode == "reference":
                    losses_g, mses_g = self._train_group_reference(
                        group, batch_size
                    )
                    losses.extend(losses_g)
                    mses.extend(mses_g)
                    continue
                dev = (
                    self._device_buckets_mixed(group)
                    if mode == "mixed"
                    else self._device_buckets_merged(group)
                )
                import zlib

                group_digest = zlib.crc32("|".join(group).encode())
                rng_np = np.random.default_rng(
                    self.epoch * 7919 + group_digest % 1000
                )
                bucket_keys = list(dev.keys())
                rng_np.shuffle(bucket_keys)
                for n in bucket_keys:
                    x_full, y_full, nv_full = dev[n]
                    s = x_full.shape[0]
                    nb = -(-s // batch_size)
                    order = rng_np.permutation(s)
                    sels = np.zeros((nb, batch_size), np.int32)
                    valids = np.zeros((nb, batch_size), bool)
                    for b, start in enumerate(range(0, s, batch_size)):
                        sel = order[start : start + batch_size]
                        # The final partial batch stays EXACT: tail slots keep
                        # valid=False and enter neither the loss nor the
                        # BatchNorm statistics (MaskedBatchNorm), matching the
                        # reference's unpadded partial batches.
                        sels[b, : len(sel)] = sel
                        valids[b, : len(sel)] = True
                    self.rng, sub = jax.random.split(self.rng)
                    keys = jax.random.split(sub, nb)
                    chunk = nb if scan_chunk is None else max(1, scan_chunk)
                    for c0 in range(0, nb, chunk):
                        c1 = min(c0 + chunk, nb)
                        self.state, bucket_losses, bucket_mses = (
                            self._train_bucket(
                                self.state,
                                x_full,
                                y_full,
                                nv_full,
                                jnp.asarray(sels[c0:c1]),
                                jnp.asarray(valids[c0:c1]),
                                keys[c0:c1],
                            )
                        )
                        losses.append(bucket_losses)
                        mses.append(bucket_mses)
            mean_loss = float(np.mean(np.concatenate([np.asarray(l) for l in losses])))
            mean_mse = float(np.mean(np.concatenate([np.asarray(m) for m in mses])))
            epoch_losses.append(mean_loss)
            epoch_mse_losses.append(mean_mse)
            self.epoch += 1
            if verbose:
                print(f"Epoch {self.epoch}: loss {mean_loss:.6g}, mse {mean_mse:.6g}")
            # on_epoch_end runs BEFORE the checkpoint save: a health-check
            # callback (train/elastic.py) that raises on a non-finite state
            # must prevent the corrupted epoch from being checkpointed, so
            # the latest checkpoint is always a known-good rollback point.
            stop = None
            if on_epoch_end is not None:
                stop = on_epoch_end(self.epoch, epoch_losses, epoch_mse_losses)
            if self.scheduler:
                self._set_lr(self.scheduler.step(mean_loss))
            if mgr and save_every > 0 and ((e + 1) % save_every == 0 or stop):
                mgr.save(self.epoch, self._ckpt_tree())
                if verbose:
                    print(f"Saved checkpoint at epoch {self.epoch}")
            if stop:
                # a truthy on_epoch_end return requests a graceful early stop
                # (e.g. a wall-clock training budget that must leave time for
                # eval); the epoch just finished is checkpointed
                # above so nothing is lost.
                if verbose:
                    print(f"Early stop requested at epoch {self.epoch}")
                break
        if mgr:
            mgr.close()
        return epoch_losses, epoch_mse_losses

    # ------------------------------------------------------------------ eval
    def test_from_dir(
        self,
        data_path: str,
        model_path: Optional[str] = None,
        sim_steps: int = 1000,
        stepwise: bool = True,
        rollout: bool = True,
        rollout_graph_spec=None,
    ):
        """Reference ``test_from_dir`` (trainer.py:94-200). Returns
        (df_stepwise grouped by (filename, scene) with mean loss/step_time,
        df_rollout indexed (filename, scene, step) with pos/vel/acc RMSE)."""
        import pandas as pd

        csv_files = _list_dataset_files(data_path)
        if not csv_files:
            raise FileNotFoundError(f"no datasets under {data_path}")

        if model_path:
            first_ds = self._dataset(csv_files[0])
            first_batch = next(iter(BatchIterator(first_ds, 1, shuffle=False)))
            self._try_resume(model_path, first_batch)
        assert self.state is not None, "no trained/loaded state"

        stepwise_rows = []
        rollout_frames = []
        for f in csv_files:
            filename = os.path.basename(f)
            ds = self._dataset(f)
            if stepwise:
                stepwise_rows.extend(self._evaluate_stepwise(filename, ds))
            if rollout:
                for scene in ds.scene_ids():
                    rollout_frames.append(
                        self._evaluate_rollout(
                            filename, ds, scene, sim_steps, rollout_graph_spec
                        )
                    )

        df_stepwise = pd.DataFrame(
            stepwise_rows,
            columns=["filename", "scene", "step", "loss", "mse_loss", "step_time"],
        )
        df_stepwise_grouped = (
            df_stepwise.groupby(["filename", "scene"]).mean()[["loss", "step_time"]]
            if len(df_stepwise)
            else df_stepwise
        )
        df_rollout = (
            pd.concat(rollout_frames).set_index(["filename", "scene", "step"])
            if rollout_frames
            else pd.DataFrame()
        )
        return df_stepwise_grouped, df_rollout

    # Repetitions for amortized stepwise timing: the reps run as ONE on-device
    # scan, so a single dispatch and sync is amortized over all of
    # them and step_time reflects per-snapshot device latency (the
    # reference's synchronous-CPU timing has no dispatch overhead to exclude).
    STEPWISE_TIMING_REPS = 64

    def _evaluate_stepwise(self, filename: str, ds: SnapshotDataset):
        """Timed 1-snapshot forwards (trainer.py:202-215). The first call per
        snapshot shape is compile-warmed before timing."""
        rows = []
        warmed = set()
        reps = self.STEPWISE_TIMING_REPS
        for batch in BatchIterator(ds, 1, shuffle=False):
            x = jnp.asarray(batch.x)
            y = jnp.asarray(batch.y)
            m = jnp.asarray(batch.node_mask)
            shape = x.shape
            if shape not in warmed:
                jax.block_until_ready(
                    self._eval_step_repeated(self.state, x, y, m, reps)[0]
                )
                warmed.add(shape)
            (loss, mse), elapsed = device_time(
                lambda: self._eval_step_repeated(self.state, x, y, m, reps)
            )
            step_time = elapsed / reps
            rows.append(
                (
                    filename,
                    int(batch.scene[0]),
                    int(batch.step[0]),
                    float(loss),
                    float(mse),
                    step_time,
                )
            )
        return rows

    def _evaluate_rollout(
        self, filename: str, ds: SnapshotDataset, scene: int, sim_steps: int,
        rollout_graph_spec=None,
    ):
        """On-chip rollout vs ground truth, aggregated exactly like the
        reference (trainer.py:179-199): per (step) mean of *signed* errors
        over particles, then RMSE across the 3 components of those means."""
        import pandas as pd

        gt = ds.scene_trajectory(scene)
        steps = min(sim_steps, gt.pos.shape[0])
        variables = {"params": self.state.params}
        if self._has_bn:
            variables["batch_stats"] = self.state.batch_stats

        def run():
            return autoregressive_rollout(
                self.model,
                variables,
                jnp.asarray(gt.pos[0]),
                jnp.asarray(gt.vel[0]),
                jnp.asarray(gt.mass),
                steps,
                self.dt,
                graph_spec=rollout_graph_spec,
            )

        key = ("rollout", gt.pos.shape[1], steps, repr(rollout_graph_spec))
        if key not in self._rollout_warmed:
            jax.block_until_ready(run()[0])  # compile warm-up; reference step_time
            self._rollout_warmed.add(key)  # excludes compilation too
        (ps, vs, accs), elapsed = device_time(run)
        step_time = elapsed / steps

        err_pos = gt.pos[:steps] - np.asarray(ps)  # (steps, N, 3) signed
        err_vel = gt.vel[:steps] - np.asarray(vs)
        err_acc = gt.acc[:steps] - np.asarray(accs)

        def rmse_of_mean(err):
            mean_err = err.mean(axis=1)  # mean over particles (groupby .mean())
            return np.sqrt((mean_err**2).mean(axis=-1))  # over x,y,z

        return pd.DataFrame(
            {
                "filename": filename,
                "scene": scene,
                "step": np.arange(steps),
                "pos_rmse": rmse_of_mean(err_pos),
                "vel_rmse": rmse_of_mean(err_vel),
                "acc_rmse": rmse_of_mean(err_acc),
                "step_time": step_time,
            }
        )
