"""Failure detection + elastic restart for training runs (SURVEY.md §5.3).

The reference has no failure story at all: a NaN loss keeps training (torch
propagates it silently through ``model_<epoch>.pt`` saves), and a crash loses
optimizer/scheduler state (``trainer.py:38-52`` restores params only). This
module supplies the single-controller-JAX analog of elastic training:

* **detection** — after every epoch, the mean loss and the full parameter
  pytree are checked for finiteness (`all_finite`, one jitted reduction —
  no per-leaf host sync). A violation raises :class:`TrainingFault` *before*
  the epoch is checkpointed (`Trainer.train_from_dir` orders the callback
  ahead of the save), so the latest checkpoint is always a known-good
  rollback point.
* **recovery** — :func:`elastic_train` catches the fault, restores the
  latest *healthy* checkpoint (checkpoints that themselves fail the health
  check — e.g. written by a crashed or preempted process — are deleted and
  the next-older one is tried), backs off the learning rate by
  ``lr_backoff`` per restart to steer the re-run away from the divergent
  trajectory, and continues until the target epoch count or the restart
  budget is exhausted.
* **process-level faults** (preemption, OOM kill) need no extra machinery:
  re-running the same command resumes from the latest healthy checkpoint via
  the same path.

Scope: single-controller JAX cannot add or drop devices mid-run (the mesh is
baked into compiled programs), so "elastic" here means surviving and
resuming within a fixed topology — multi-slice device-set elasticity is out
of scope per SURVEY.md §5.8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nbody_sim.data.dataset import BatchIterator
from nbody_sim.train.checkpoint import CheckpointManager


@jax.jit
def _finite_reduce(tree) -> jax.Array:
    leaves = [jnp.all(jnp.isfinite(x)) for x in jax.tree_util.tree_leaves(tree)
              if jnp.issubdtype(jnp.asarray(x).dtype, jnp.inexact)]
    return jnp.all(jnp.stack(leaves)) if leaves else jnp.asarray(True)


def all_finite(tree) -> bool:
    """True iff every inexact leaf of ``tree`` is free of NaN/Inf."""
    return bool(_finite_reduce(tree))


class TrainingFault(RuntimeError):
    """A detected training-health violation (non-finite loss or params)."""

    def __init__(self, epoch: int, reason: str):
        super().__init__(f"training fault at epoch {epoch}: {reason}")
        self.epoch = epoch
        self.reason = reason


@dataclasses.dataclass
class ElasticResult:
    """Outcome of an :func:`elastic_train` run.

    ``epoch_losses``/``epoch_mses`` hold the *surviving* value per epoch in
    epoch order (a faulted epoch's numbers are replaced by its re-run's;
    epochs completed by an earlier process invocation are not re-reported).
    """

    epoch_losses: List[float]
    epoch_mses: List[float]
    restarts: int
    faults: List[Tuple[int, str]]


def _latest_healthy_epoch(trainer, save_path: str, first_batch) -> int:
    """Resume the trainer from the newest checkpoint whose restored state
    passes the health check, deleting unhealthy ones. Returns the resumed
    epoch (0 = fresh start)."""
    trainer._ensure_state(first_batch)
    mgr = CheckpointManager(save_path)
    try:
        while True:
            step, tree = mgr.restore_latest(trainer._ckpt_tree())
            if step is None:
                return 0
            if all_finite(tree["state"].params):
                # apply the restore (mirrors Trainer._try_resume) so the
                # trainer holds the checkpointed state even when no further
                # training runs (epochs already reached => elastic_train
                # returns without calling train_from_dir)
                trainer.state = tree["state"]
                trainer.epoch = int(tree["epoch"])
                trainer.rng = jnp.asarray(tree["rng"])
                if trainer.scheduler and "scheduler" in tree:
                    trainer.scheduler.load_state_dict(
                        {k: float(v) for k, v in tree["scheduler"].items()}
                    )
                    trainer._set_lr(trainer.scheduler.lr)
                return int(tree["epoch"])
            print(f"Elastic: checkpoint at epoch {step} is unhealthy "
                  "(non-finite params) — deleting it")
            mgr.delete(step)
    finally:
        mgr.close()


def elastic_train(
    trainer,
    data_path: str,
    epochs: int,
    batch_size: int,
    save_path: str,
    save_every: int = 1,
    max_restarts: int = 2,
    lr_backoff: float = 0.5,
    verbose: bool = True,
    on_epoch_end: Optional[Callable] = None,
    **train_kwargs,
) -> ElasticResult:
    """Run ``trainer.train_from_dir`` to ``epochs`` total epochs with
    fault detection and checkpoint-rollback restarts.

    :param trainer: a :class:`nbody_sim.train.Trainer`.
    :param save_path: checkpoint directory (required — it is the rollback
        store; ``save_every`` must be >= 1).
    :param max_restarts: fault budget; the fault that exhausts it re-raises.
    :param lr_backoff: multiplicative LR factor applied per restart
        (cumulative), on top of the restored checkpoint's LR.
    :param on_epoch_end: optional user callback, invoked after the health
        check passes (same signature as ``train_from_dir``'s).
    :param train_kwargs: forwarded to ``train_from_dir`` (batch_mode, ...).
    """
    if save_every < 1:
        raise ValueError("elastic_train requires save_every >= 1")

    from nbody_sim.train.trainer import _list_dataset_files

    files = _list_dataset_files(data_path)
    if not files:
        raise FileNotFoundError(f"no datasets under {data_path}")
    first_batch = next(
        iter(BatchIterator(trainer._dataset(files[0]), batch_size,
                           shuffle=False)))

    # fresh-start fallback state (a fault before the first save rolls back
    # to a re-seeded scratch run, not to the corrupted in-memory state) —
    # incl. the scheduler's plateau counters/LR, which the faulted run mutated
    rng0 = np.asarray(trainer.rng).copy()
    sched0 = trainer.scheduler.state_dict() if trainer.scheduler else None

    loss_by_epoch: dict = {}
    mse_by_epoch: dict = {}

    def checked(epoch, losses, mses):
        if not np.isfinite(losses[-1]):
            raise TrainingFault(epoch, f"non-finite epoch loss {losses[-1]}")
        if not all_finite(trainer.state.params):
            raise TrainingFault(epoch, "non-finite parameters")
        loss_by_epoch[epoch] = losses[-1]
        mse_by_epoch[epoch] = mses[-1]
        if on_epoch_end is not None:
            on_epoch_end(epoch, losses, mses)

    restarts = 0
    faults: List[Tuple[int, str]] = []
    while True:
        resumed = _latest_healthy_epoch(trainer, save_path, first_batch)
        if resumed == 0 and restarts:
            # no healthy checkpoint: full scratch restart
            trainer.state = None
            trainer.epoch = 0
            trainer.rng = jnp.asarray(rng0)
            if sched0 is not None:
                trainer.scheduler.load_state_dict(sched0)
        remaining = epochs - resumed
        if remaining <= 0:
            break
        try:
            trainer.train_from_dir(
                data_path, epochs=remaining, batch_size=batch_size,
                save_every=save_every, save_path=save_path, verbose=verbose,
                on_epoch_end=checked,
                lr_scale=(lr_backoff ** restarts if restarts else None),
                **train_kwargs,
            )
            break
        except TrainingFault as f:
            faults.append((f.epoch, f.reason))
            restarts += 1
            if verbose:
                print(f"Elastic: {f} — restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise

    seen = sorted(loss_by_epoch)
    return ElasticResult(
        epoch_losses=[loss_by_epoch[e] for e in seen],
        epoch_mses=[mse_by_epoch[e] for e in seen],
        restarts=restarts,
        faults=faults,
    )
