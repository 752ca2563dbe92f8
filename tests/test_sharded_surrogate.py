"""Particle-sharded surrogate (``parallel/surrogate.py``) vs the
single-device forward — exact equality on the virtual 8-CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.models import GraphModel
from nbody_sim.parallel.surrogate import sharded_predict, sharded_rollout
from nbody_sim.train.graphs import build_graph
from nbody_sim.train.rollout import autoregressive_rollout, predict_accelerations


def _setup(model, n, seed=0):
    key = jax.random.PRNGKey(seed)
    kp, kv, km, ki = jax.random.split(key, 4)
    pos = jax.random.normal(kp, (n, 3))
    vel = jax.random.normal(kv, (n, 3)) * 0.1
    mass = jax.random.uniform(km, (n,), minval=0.5, maxval=1.5)
    x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
    idx, valid = build_graph(model.graph_spec, x[..., :3])
    variables = model.init(ki, x, idx, valid)
    return pos, vel, mass, variables


@pytest.mark.parametrize("encoder,aggr", [
    (None, "mean"),
    ((16,), "sum"),
])
def test_sharded_predict_matches_single_device(mesh8, encoder, aggr):
    model = GraphModel(
        input_dim=4, gnn_dim=16, message_passing_steps=2, aggr=aggr,
        node_encoder_dims=encoder, neighbors=5, scale_factor=1e6,
        output_scale=1e3,  # non-default: pins the sharded forward's
        # output_scale division (regression: it was silently omitted)
    )
    n = 64  # 8 per device
    pos, vel, mass, variables = _setup(model, n)

    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-7
    )


def test_sharded_rollout_matches_single_device(mesh8):
    model = GraphModel(
        input_dim=4, gnn_dim=8, message_passing_steps=2, aggr="mean",
        neighbors=4, scale_factor=1e6,
    )
    n, steps, dt = 40, 5, 1e-3
    pos, vel, mass, variables = _setup(model, n, seed=1)

    want = autoregressive_rollout(
        model, variables, pos, vel, mass, steps, dt
    )
    got = sharded_rollout(model, variables, pos, vel, mass, steps, dt, mesh8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), rtol=5e-5, atol=1e-7
        )


def test_sharded_predict_with_output_hiddens(mesh8):
    model = GraphModel(
        input_dim=7, gnn_dim=8, message_passing_steps=1, aggr="mean",
        output_hiddens=(12,), neighbors=3, scale_factor=1e6,
    )
    pos, vel, mass, variables = _setup(model, 32, seed=2)
    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-7
    )


def test_sharded_contconv_matches_single_device(mesh8):
    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_predict

    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4, 3), radius=1.5,
        continuous_conv_layers=2, continuous_conv_dim=8,
        encoder_hiddens=(8,), decoder_hiddens=(8,), scale_factor=1e6,
        radius_kmax=6, self_loops=True,
        output_scale=1e3,  # non-default: pins the sharded forward's division
    )
    n = 48
    pos, vel, mass, variables = _setup(model, n, seed=3)
    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_contconv_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=5e-5, atol=1e-7
    )


def test_sharded_contconv_no_encoder(mesh8):
    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_predict

    model = ContinuousConvModel(
        in_channels=7, filter_resolution=4, radius=2.0,
        continuous_conv_layers=1, continuous_conv_dim=8,
        scale_factor=1e6, radius_kmax=5, self_loops=False, agg="sum",
    )
    pos, vel, mass, variables = _setup(model, 32, seed=4)
    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_contconv_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=5e-5, atol=1e-7
    )


def test_sharded_predict_morton_graph(mesh8):
    """The morton graph spec routes through the replicated curve search +
    shard slice (``_shard_knn``); the graph is bit-identical to the
    single-device build, so the forward must agree exactly."""
    model = GraphModel(
        input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
        neighbors=5, scale_factor=1e6,
        knn_method="morton",
    )
    n = 640  # large enough for the blocked (non-degenerate) morton path
    pos, vel, mass, variables = _setup(model, n, seed=5)
    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=2e-5, atol=1e-7
    )


def test_sharded_contconv_morton_graph(mesh8):
    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_predict

    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4,), radius=1.0,
        continuous_conv_layers=1, continuous_conv_dim=8,
        scale_factor=1e6, radius_kmax=6, self_loops=True,
        radius_method="morton",
    )
    pos, vel, mass, variables = _setup(model, 640, seed=6)
    want = predict_accelerations(model, variables, pos, vel, mass)
    got = sharded_contconv_predict(model, variables, pos, vel, mass, mesh8)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=5e-5, atol=1e-7
    )


def test_sharded_loss_and_grad_matches_single_device(mesh8):
    """jax.grad THROUGH the particle-sharded forward == single-device
    gradients: the all_gathers differentiate into
    collectives and the per-shard parameter contributions psum."""
    from nbody_sim.parallel.surrogate import sharded_loss_and_grad

    model = GraphModel(
        input_dim=4, gnn_dim=16, message_passing_steps=2, aggr="mean",
        node_encoder_dims=(8,), neighbors=5, scale_factor=1e6,
        output_scale=1e3,  # non-default: the sharded grad must descend the
        # same (output-scaled) objective as the single-device trainer
    )
    n = 64
    pos, vel, mass, variables = _setup(model, n, seed=5)
    y = jax.random.normal(jax.random.PRNGKey(6), (n, 3)) * 1e-6

    def single_loss(params):
        pred = predict_accelerations(
            model, {"params": params}, pos, vel, mass)
        return jnp.sqrt(jnp.mean((model.scale_factor * (pred - y)) ** 2))

    want_loss, want_g = jax.value_and_grad(single_loss)(variables["params"])
    got_loss, got_g = sharded_loss_and_grad(
        model, variables, pos, vel, mass, y, mesh8)

    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    flat_w, _ = jax.tree_util.tree_flatten(want_g)
    flat_g, _ = jax.tree_util.tree_flatten(got_g)
    for w, g in zip(flat_w, flat_g):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=2e-4, atol=1e-7)


def test_sharded_grad_descends(mesh8):
    """A few optax steps on the sharded gradients reduce the sharded loss —
    the minimal particle-sharded training loop."""
    import optax

    from nbody_sim.parallel.surrogate import sharded_loss_and_grad

    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                       aggr="mean", neighbors=4, scale_factor=1e6)
    n = 48
    pos, vel, mass, variables = _setup(model, n, seed=7)
    y = jax.random.normal(jax.random.PRNGKey(8), (n, 3)) * 1e-6

    tx = optax.adam(1e-2)
    params = variables["params"]
    opt_state = tx.init(params)
    losses = []
    for _ in range(5):
        loss, g = sharded_loss_and_grad(
            model, {"params": params}, pos, vel, mass, y, mesh8)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def _contconv_single_loss_and_grad(model, variables, pos, vel, mass, y):
    """Single-device train-mode scaled-RMSE loss/grad — what the Trainer's
    step computes (train=True, mutable batch_stats) on a (1, N) batch."""

    def loss_fn(params):
        x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
        idx, valid = build_graph(model.graph_spec, x[..., :3])
        pred, mut = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            x, idx, valid, train=True, mutable=["batch_stats"],
        )
        loss = jnp.sqrt(
            jnp.mean((model.scale_factor * (pred[0] - y)) ** 2))
        return loss, mut["batch_stats"]

    (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    return loss, g, new_bs


def test_sharded_contconv_loss_and_grad_matches_single_device(mesh8):
    """The ContConv twin of the sharded training step: loss, parameter
    grads AND the updated encoder BatchNorm running stats must match the
    single-device train-mode step."""
    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_loss_and_grad

    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4, 3), radius=1.5,
        continuous_conv_layers=2, continuous_conv_dim=8,
        encoder_hiddens=(8,), decoder_hiddens=(8,), scale_factor=1e6,
        radius_kmax=6, self_loops=True,
        output_scale=1e3,  # non-default: the sharded grad must descend the
        # same (output-scaled) objective as the single-device trainer
    )
    n = 64
    pos, vel, mass, variables = _setup(model, n, seed=10)
    y = jax.random.normal(jax.random.PRNGKey(11), (n, 3)) * 1e-6

    want_loss, want_g, want_bs = _contconv_single_loss_and_grad(
        model, variables, pos, vel, mass, y)
    got_loss, got_g, got_bs = sharded_contconv_loss_and_grad(
        model, variables, pos, vel, mass, y, mesh8)

    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    for (pw, w), (pg, g) in zip(
        jax.tree_util.tree_flatten_with_path(want_g)[0],
        jax.tree_util.tree_flatten_with_path(got_g)[0],
    ):
        assert pw == pg
        # atol: an encoder Dense bias feeding BatchNorm has EXACTLY zero
        # gradient (the batch-mean subtraction cancels it), so both sides
        # are pure fp32 cancellation noise ~1e-6 there
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=2e-4, atol=1e-5, err_msg=str(pw))
    flat_wbs, _ = jax.tree_util.tree_flatten(want_bs)
    flat_gbs, _ = jax.tree_util.tree_flatten(got_bs)
    for w, g in zip(flat_wbs, flat_gbs):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-8)


def test_sharded_contconv_grad_descends(mesh8):
    """A few optax steps on the sharded ContConv gradients (carrying the
    returned batch_stats) reduce the sharded loss — the minimal
    particle-sharded ContConv training loop."""
    import optax

    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_loss_and_grad

    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4,), radius=1.5,
        continuous_conv_layers=1, continuous_conv_dim=8,
        encoder_hiddens=(8,), scale_factor=1e6, radius_kmax=5,
        self_loops=True,
    )
    n = 48
    pos, vel, mass, variables = _setup(model, n, seed=12)
    y = jax.random.normal(jax.random.PRNGKey(13), (n, 3)) * 1e-6

    tx = optax.adam(1e-2)
    params = variables["params"]
    bstats = variables["batch_stats"]
    opt_state = tx.init(params)
    losses = []
    for _ in range(5):
        loss, g, bstats = sharded_contconv_loss_and_grad(
            model, {"params": params, "batch_stats": bstats},
            pos, vel, mass, y, mesh8)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_sharded_contconv_rollout_matches_single_device(mesh8):
    from nbody_sim.models import ContinuousConvModel
    from nbody_sim.parallel.surrogate import sharded_contconv_rollout

    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4, 3), radius=1.5,
        continuous_conv_layers=2, continuous_conv_dim=8,
        encoder_hiddens=(8,), decoder_hiddens=(8,), scale_factor=1e6,
        radius_kmax=6, self_loops=True,
    )
    n, steps, dt = 48, 4, 1e-3
    pos, vel, mass, variables = _setup(model, n, seed=9)
    want = autoregressive_rollout(model, variables, pos, vel, mass, steps, dt)
    got = sharded_contconv_rollout(model, variables, pos, vel, mass, steps,
                                   dt, mesh8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=5e-4, atol=1e-6)
