"""Training engine: end-to-end tiny runs, checkpoint resume, scheduler
semantics, rollout physics parity (SURVEY.md §4 integration tests)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.core.forces import pairwise_accelerations
from nbody_sim.core.simulate import SimulationConfig, simulate
from nbody_sim.data.generate import ScenarioConfig, generate_dataset
from nbody_sim.models import GraphModel
from nbody_sim.train import PlateauScheduler, Trainer
from nbody_sim.train.rollout import autoregressive_rollout

G, EPS, DT = 4.5e-6, 0.05, 1e-4


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    train_dir, test_dir = root / "train", root / "test"
    train_dir.mkdir(), test_dir.mkdir()
    scenarios = [
        ScenarioConfig(n_bodies=8, sim_type="spiral", steps=20, seed=1,
                       force_backend="dense"),
        ScenarioConfig(n_bodies=12, sim_type="disk", steps=20, seed=2,
                       force_backend="dense"),
    ]
    generate_dataset(scenarios, str(train_dir / "f1.csv"), verbose=False)
    generate_dataset(
        [ScenarioConfig(n_bodies=8, sim_type="spiral", steps=20, seed=3,
                        force_backend="dense")],
        str(test_dir / "t1.csv"),
        verbose=False,
    )
    return str(train_dir), str(test_dir)


def _model():
    return GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2,
                      aggr="mean", neighbors=4, scale_factor=1e6)


def test_training_reduces_loss(tiny_data):
    train_dir, _ = tiny_data
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    losses, mses = trainer.train_from_dir(
        train_dir, epochs=8, batch_size=8, verbose=False
    )
    assert len(losses) == 8
    assert losses[-1] < losses[0] * 0.9
    assert np.isfinite(losses).all()


def test_checkpoint_resume(tiny_data, tmp_path):
    train_dir, _ = tiny_data
    save = str(tmp_path / "ckpt")

    t1 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0,
                 scheduler=PlateauScheduler(lr=0.01, factor=0.25, patience=5))
    t1.train_from_dir(train_dir, epochs=2, batch_size=8, save_every=1,
                      save_path=save, verbose=False)
    assert t1.epoch == 2

    t2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0,
                 scheduler=PlateauScheduler(lr=0.01, factor=0.25, patience=5))
    t2.train_from_dir(train_dir, epochs=1, batch_size=8, save_every=1,
                      save_path=save, verbose=False)
    # resumed from epoch 2, trained 1 more (the reference restarts numbering,
    # trainer.py:38 — fixed here)
    assert t2.epoch == 3
    # params actually restored: both states exist and differ from fresh init
    p1 = jax.tree_util.tree_leaves(t1.state.params)[0]
    p2 = jax.tree_util.tree_leaves(t2.state.params)[0]
    assert p1.shape == p2.shape


@pytest.mark.parametrize("dropout", [False, True])
def test_resume_is_bit_exact(tiny_data, tmp_path, dropout):
    """train(4) == train(2)+resume(2) EXACTLY: the checkpoint carries params,
    optimizer, scheduler, epoch and the RNG key (a resumed run must replay
    the same dropout/shuffle stream — train/checkpoint.py docstring)."""
    train_dir, _ = tiny_data

    def make():
        kw = dict(input_dim=4, gnn_dim=8, message_passing_steps=1,
                  aggr="mean", neighbors=4, scale_factor=1e6)
        if dropout:
            kw.update(node_encoder_dims=(8,), encoder_dropout=0.3)
        return GraphModel(**kw)

    def trainer():
        return Trainer(make(), learning_rate=0.01, dt=DT, seed=0,
                       scheduler=PlateauScheduler(lr=0.01, factor=0.5,
                                                  patience=1))

    t_full = trainer()
    full_losses, _ = t_full.train_from_dir(
        train_dir, epochs=4, batch_size=8, verbose=False)

    save = str(tmp_path / f"ckpt_dropout_{dropout}")
    t1 = trainer()
    t1.train_from_dir(train_dir, epochs=2, batch_size=8, save_every=2,
                      save_path=save, verbose=False)
    t2 = trainer()
    resumed_losses, _ = t2.train_from_dir(
        train_dir, epochs=2, batch_size=8, save_path=save, verbose=False)

    assert resumed_losses == full_losses[2:]
    for a, b in zip(jax.tree_util.tree_leaves(t_full.state.params),
                    jax.tree_util.tree_leaves(t2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_plateau_scheduler_matches_torch_semantics():
    s = PlateauScheduler(lr=1.0, factor=0.5, patience=2, threshold=1e-4)
    lrs = []
    # improving, then 3 bad epochs -> reduction on the 3rd bad epoch
    for metric in [10.0, 9.0, 9.0, 9.0, 9.0]:
        lrs.append(s.step(metric))
    # torch: bad epochs at 9.0(#2: not < 9*(1-1e-4)), counts 1,2,3>patience
    assert lrs == [1.0, 1.0, 1.0, 1.0, 0.5]
    # counter reset after reduction
    assert s.num_bad_epochs == 0


class _GravityOracle:
    """Fake 'surrogate' that predicts exact softened gravity — lets us test
    that the on-chip rollout reproduces the simulator trajectory."""

    graph_spec = ("knn", {"k": 4, "include_self": False})
    scale_factor = 1.0

    def apply(self, variables, x, idx, valid, train=False, **kw):
        pos, mass = x[..., :3], x[..., 6]
        return jax.vmap(
            lambda p, m: pairwise_accelerations(p, m, G, EPS)
        )(pos, mass)


def test_rollout_matches_simulator():
    rng = np.random.default_rng(0)
    n, steps = 10, 15
    pos0 = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    vel0 = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32) * 0.1)
    mass = jnp.asarray(rng.uniform(0.5, 1, n).astype(np.float32))

    ps, vs, accs = autoregressive_rollout(
        _GravityOracle(), {}, pos0, vel0, mass, steps, DT
    )
    cfg = SimulationConfig(g_const=G, softening=EPS, dt=DT,
                           integrator="leapfrog", calc_energy=False,
                           force_backend="dense")
    traj = simulate(pos0, vel0, mass, steps - 1, cfg)
    np.testing.assert_allclose(
        np.asarray(ps[1:]), np.asarray(traj.positions), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(vs[1:]), np.asarray(traj.velocities), rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(accs[1:]), np.asarray(traj.accelerations), rtol=1e-4, atol=1e-8
    )
    # row 0 is the seed state with the predicted initial acceleration
    np.testing.assert_allclose(np.asarray(ps[0]), np.asarray(pos0))


def test_test_from_dir_schema(tiny_data, tmp_path):
    train_dir, test_dir = tiny_data
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT)
    trainer.train_from_dir(train_dir, epochs=1, batch_size=8, verbose=False)
    df_stepwise, df_rollout = trainer.test_from_dir(
        test_dir, sim_steps=20, stepwise=True, rollout=True
    )
    assert list(df_stepwise.columns) == ["loss", "step_time"]
    assert df_stepwise.index.names == ["filename", "scene"]
    for col in ["pos_rmse", "vel_rmse", "acc_rmse"]:
        assert col in df_rollout.columns
    assert df_rollout.index.names == ["filename", "scene", "step"]
    # one rollout row per step
    assert len(df_rollout.loc[("t1.csv", 0)]) == 20
    assert np.isfinite(df_rollout["pos_rmse"].to_numpy()).all()
    # step-0 position error is exactly zero (seeded from ground truth)
    assert df_rollout.loc[("t1.csv", 0, 0), "pos_rmse"] == 0.0


def test_data_parallel_training(tiny_data, mesh8):
    """Trainer(mesh=...) shards batches over the "data" axis; loss curve
    stays finite and decreasing like the single-device run."""
    train_dir, _ = tiny_data
    from nbody_sim.parallel.mesh import DATA_AXIS, make_mesh

    mesh = make_mesh(8, axis_names=(DATA_AXIS,))
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0, mesh=mesh)
    losses, _ = trainer.train_from_dir(
        train_dir, epochs=6, batch_size=8, verbose=False
    )
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_data_parallel_reference_batch_mode(tiny_data, mesh8):
    """batch_mode="reference" shards its per-bucket sub-batches over the dp
    axis (quotas padded to the axis size); loss parity with single-device."""
    train_dir, _ = tiny_data
    from nbody_sim.parallel.mesh import DATA_AXIS, make_mesh

    single = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    l1, _ = single.train_from_dir(train_dir, epochs=3, batch_size=8,
                                  verbose=False, batch_mode="reference")
    mesh = make_mesh(8, axis_names=(DATA_AXIS,))
    dp = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0, mesh=mesh)
    l2, _ = dp.train_from_dir(train_dir, epochs=3, batch_size=8,
                              verbose=False, batch_mode="reference")
    assert np.isfinite(l2).all()
    np.testing.assert_allclose(l1, l2, rtol=2e-4)


def test_merge_files_training(tiny_data):
    train_dir, _ = tiny_data
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    losses, _ = trainer.train_from_dir(
        train_dir, epochs=4, batch_size=8, verbose=False, merge_files=True
    )
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_plateau_scheduler_cooldown_matches_torch():
    """Cooldown decrements every epoch post-reduction, zeroing num_bad."""
    s = PlateauScheduler(lr=1.0, factor=0.5, patience=1, threshold=1e-4,
                         cooldown=2)
    lrs = [s.step(m) for m in [10.0, 10.0, 10.0,  # bad x2 > patience -> cut
                               5.0, 10.0,          # cooldown (improving, bad)
                               10.0, 10.0]]        # bad x2 -> second cut
    assert lrs == [1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.25]


def test_predict_accelerations_matches_rollout_seed():
    from nbody_sim.train.rollout import predict_accelerations

    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.normal(size=(9, 3)).astype(np.float32))
    vel = jnp.asarray(rng.normal(size=(9, 3)).astype(np.float32))
    mass = jnp.asarray(rng.uniform(0.5, 1, 9).astype(np.float32))
    acc = predict_accelerations(_GravityOracle(), {}, pos, vel, mass)
    want = pairwise_accelerations(pos, mass, G, EPS)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(want), rtol=1e-5)


def test_rollout_graph_refresh():
    """Verlet-style neighbor-list reuse: refresh=1 is the exact reference
    semantics; refresh=3 must produce the same shapes and stay close over a
    short horizon (dt=1e-4 moves particles ~1e-5 per step)."""
    import jax
    import jax.numpy as jnp

    from nbody_sim.models import GraphModel
    from nbody_sim.train.graphs import build_graph
    from nbody_sim.train.rollout import autoregressive_rollout

    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                       aggr="mean", neighbors=4, scale_factor=1e6)
    key = jax.random.PRNGKey(0)
    pos = jax.random.normal(key, (20, 3))
    vel = jax.random.normal(jax.random.PRNGKey(1), (20, 3)) * 1e-3
    mass = jnp.ones(20)
    x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, x[..., :3])
    variables = model.init(jax.random.PRNGKey(2), x, idx, valid)

    base = autoregressive_rollout(model, variables, pos, vel, mass, 8, 1e-4)
    reuse = autoregressive_rollout(model, variables, pos, vel, mass, 8, 1e-4,
                                   graph_refresh=3)  # 7 steps = 3 segments, padded
    assert all(b.shape == r.shape for b, r in zip(base, reuse))
    np.testing.assert_allclose(
        np.asarray(reuse[0]), np.asarray(base[0]), rtol=1e-4, atol=1e-6
    )


def test_resume_from_legacy_rngless_checkpoint(tiny_data, tmp_path):
    """Checkpoints written before the RNG key joined _ckpt_tree
    restore with the in-memory key instead of crashing on the tree-structure
    mismatch."""
    from nbody_sim.train.checkpoint import CheckpointManager

    train_dir, _ = tiny_data
    save = str(tmp_path / "ckpt")

    t1 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    t1.train_from_dir(train_dir, epochs=2, batch_size=8, verbose=False)

    legacy = t1._ckpt_tree()
    legacy.pop("rng")  # the older tree shape
    mgr = CheckpointManager(save)
    mgr.save(2, legacy)
    mgr.close()

    t2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    t2.train_from_dir(train_dir, epochs=1, batch_size=8, save_path=save,
                      verbose=False)
    assert t2.epoch == 3  # resumed from the legacy epoch-2 checkpoint


def test_scan_chunk_is_bit_exact(tiny_data):
    """scan_chunk splits the whole-bucket training scan into capped
    dispatches (bounding one execution's length at 1M bodies) without
    changing the math: same seeds => identical epoch losses and parameters."""
    train_dir, _ = tiny_data

    t1 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    l1, _ = t1.train_from_dir(train_dir, epochs=2, batch_size=4,
                              verbose=False)
    t2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    l2, _ = t2.train_from_dir(train_dir, epochs=2, batch_size=4,
                              verbose=False, scan_chunk=2)
    assert l1 == l2
    for a, b in zip(jax.tree_util.tree_leaves(t1.state.params),
                    jax.tree_util.tree_leaves(t2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_on_epoch_end_early_stop(tiny_data, tmp_path):
    """A truthy on_epoch_end return stops the epoch loop gracefully after
    checkpointing the finished epoch — the wall-clock training-budget hook
    (train_large --train-time-budget) that guarantees eval chip time."""
    train_dir, _ = tiny_data
    save = str(tmp_path / "ckpt")
    trainer = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    losses, _ = trainer.train_from_dir(
        train_dir, epochs=10, batch_size=8, verbose=False,
        save_every=5, save_path=save,
        on_epoch_end=lambda e, l, m: e >= 3,
    )
    assert len(losses) == 3 and trainer.epoch == 3

    # the stop epoch was checkpointed even though 3 % save_every != 0,
    # so a follow-up resume continues from it (epochs = N MORE epochs)
    # rather than re-running it
    trainer2 = Trainer(_model(), learning_rate=0.01, dt=DT, seed=0)
    losses2, _ = trainer2.train_from_dir(
        train_dir, epochs=2, batch_size=8, verbose=False,
        save_every=5, save_path=save,
    )
    assert trainer2.epoch == 5 and len(losses2) == 2
