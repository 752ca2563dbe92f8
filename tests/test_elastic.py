"""Failure detection + elastic restart (SURVEY.md §5.3): fault injection
into a real training run, rollback to the last healthy checkpoint, LR
backoff, corrupt-checkpoint skipping, restart-budget exhaustion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.data.generate import ScenarioConfig, generate_dataset
from nbody_sim.models import GraphModel
from nbody_sim.train import Trainer, TrainingFault, all_finite, elastic_train
from nbody_sim.train.checkpoint import CheckpointManager

DT = 1e-4


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    train_dir = tmp_path_factory.mktemp("data") / "train"
    train_dir.mkdir()
    generate_dataset(
        [ScenarioConfig(n_bodies=8, sim_type="spiral", steps=16, seed=1,
                        force_backend="dense")],
        str(train_dir / "f1.csv"), verbose=False,
    )
    return str(train_dir)


def _model():
    return GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2,
                      aggr="mean", neighbors=4, scale_factor=1e6)


def _nan_params(params):
    return jax.tree_util.tree_map(lambda x: jnp.full_like(x, jnp.nan), params)


def test_all_finite():
    assert all_finite({"a": jnp.ones(3), "n": np.arange(4)})
    assert not all_finite({"a": jnp.array([1.0, jnp.nan])})
    assert not all_finite({"a": jnp.ones(2), "b": {"c": jnp.array(jnp.inf)}})


def test_elastic_recovers_from_injected_fault(tiny_data, tmp_path):
    """Params corrupted mid-run at epoch 3: the health check fires at epoch
    4 BEFORE that epoch is checkpointed, the run rolls back to the epoch-3
    checkpoint, and still completes all target epochs with finite losses."""
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    state = {"armed": True}

    def inject(epoch, losses, mses):
        if epoch == 3 and state["armed"]:
            state["armed"] = False
            trainer.state = trainer.state.replace(
                params=_nan_params(trainer.state.params))

    res = elastic_train(
        trainer, tiny_data, epochs=6, batch_size=8,
        save_path=str(tmp_path / "ckpt"), save_every=1,
        max_restarts=2, verbose=False, on_epoch_end=inject,
    )
    assert res.restarts == 1
    assert [e for e, _ in res.faults] == [4]
    assert len(res.epoch_losses) == 6
    assert np.isfinite(res.epoch_losses).all()
    assert trainer.epoch == 6
    assert all_finite(trainer.state.params)


def test_elastic_lr_backoff_applied(tiny_data, tmp_path):
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    state = {"armed": True}

    def inject(epoch, losses, mses):
        if epoch == 2 and state["armed"]:
            state["armed"] = False
            trainer.state = trainer.state.replace(
                params=_nan_params(trainer.state.params))

    elastic_train(
        trainer, tiny_data, epochs=4, batch_size=8,
        save_path=str(tmp_path / "ckpt"), save_every=1,
        max_restarts=1, lr_backoff=0.5, verbose=False, on_epoch_end=inject,
    )
    lr = float(trainer.state.opt_state.hyperparams["learning_rate"])
    assert lr == pytest.approx(0.005)


def test_elastic_exhausts_restart_budget(tiny_data, tmp_path):
    """A fault that recurs on every attempt re-raises once the budget is
    spent (here: the callback corrupts params after every epoch 2)."""
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)

    def always_inject(epoch, losses, mses):
        if epoch == 2:
            trainer.state = trainer.state.replace(
                params=_nan_params(trainer.state.params))

    with pytest.raises(TrainingFault):
        elastic_train(
            trainer, tiny_data, epochs=4, batch_size=8,
            save_path=str(tmp_path / "ckpt"), save_every=1,
            max_restarts=2, verbose=False, on_epoch_end=always_inject,
        )


def test_elastic_skips_corrupt_checkpoint(tiny_data, tmp_path):
    """A checkpoint holding non-finite params (crashed-writer scenario) is
    deleted at resume and the next-older healthy one is used instead."""
    save = str(tmp_path / "ckpt")
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    trainer.train_from_dir(tiny_data, epochs=2, batch_size=8,
                           save_every=1, save_path=save, verbose=False)
    # hand-write a corrupt epoch-3 checkpoint
    trainer.state = trainer.state.replace(
        params=_nan_params(trainer.state.params))
    trainer.epoch = 3
    mgr = CheckpointManager(save)
    mgr.save(3, trainer._ckpt_tree())
    mgr.close()

    trainer2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    res = elastic_train(
        trainer2, tiny_data, epochs=4, batch_size=8, save_path=save,
        save_every=1, max_restarts=0, verbose=False,
    )
    assert res.restarts == 0
    assert trainer2.epoch == 4
    assert all_finite(trainer2.state.params)
    # resumed from the healthy epoch-2 checkpoint -> re-ran epochs 3 and 4
    assert len(res.epoch_losses) == 2


def test_elastic_scratch_restart_without_checkpoint(tiny_data, tmp_path):
    """A fault at epoch 1 (before any save) falls back to a re-seeded
    scratch restart rather than resuming the corrupted in-memory state."""
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    state = {"armed": True}

    def inject(epoch, losses, mses):
        if epoch == 1 and state["armed"]:
            state["armed"] = False
            trainer.state = trainer.state.replace(
                params=_nan_params(trainer.state.params))

    res = elastic_train(
        trainer, tiny_data, epochs=3, batch_size=8,
        save_path=str(tmp_path / "ckpt"), save_every=1,
        max_restarts=1, verbose=False, on_epoch_end=inject,
    )
    assert res.restarts == 1
    assert trainer.epoch == 3
    assert np.isfinite(res.epoch_losses).all()


def test_elastic_rerun_already_complete_restores_checkpoint(
        tiny_data, tmp_path):
    """Re-running elastic_train when the target epochs are already
    checkpointed must leave the trainer holding the CHECKPOINTED state, not
    freshly-initialized params (regression: the early break skipped the
    restore)."""
    ckpt = str(tmp_path / "ckpt")
    t1 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    elastic_train(t1, tiny_data, epochs=3, batch_size=8, save_path=ckpt,
                  save_every=1, verbose=False)
    trained = jax.tree_util.tree_leaves(t1.state.params)

    t2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=99)
    res = elastic_train(t2, tiny_data, epochs=3, batch_size=8,
                        save_path=ckpt, save_every=1, verbose=False)
    assert res.restarts == 0
    assert t2.epoch == 3
    for a, b in zip(trained, jax.tree_util.tree_leaves(t2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_elastic_scratch_restart_resets_scheduler(tiny_data, tmp_path):
    """A fault before the first checkpoint re-seeds the run from scratch —
    including the PlateauScheduler's counters, which the faulted attempt
    mutated (regression: only state/epoch/rng were reset)."""
    from nbody_sim.train.optim import PlateauScheduler

    sched = PlateauScheduler(lr=0.01, factor=0.5, patience=0)
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0,
                      scheduler=sched)
    state = {"armed": True}

    def inject(epoch, losses, mses):
        # let the plateau fire at least once, then corrupt before any save
        sched.best = 0.0  # force num_bad_epochs growth on every epoch
        if epoch == 2 and state["armed"]:
            state["armed"] = False
            trainer.state = trainer.state.replace(
                params=_nan_params(trainer.state.params))

    elastic_train(
        trainer, tiny_data, epochs=3, batch_size=8,
        save_path=str(tmp_path / "ckpt"), save_every=10,  # no save before fault
        max_restarts=2, verbose=False, on_epoch_end=inject,
    )
    # scheduler was reloaded from its pre-run state on the scratch restart:
    # the restarted run's plateau decays start from lr=0.01, not from the
    # faulted run's decayed value compounded again
    assert trainer.epoch == 3
