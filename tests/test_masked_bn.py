"""Masked BatchNorm + torch-init parity.

The reference's ContConv encoder normalizes over exactly the real nodes
(torch BatchNorm1d on PyG's unpadded node batch, ``contconv.py:135-141``);
these tests pin (a) batch statistics invariant to padded rows, (b) torch
BatchNorm1d running-stat semantics, and (c) PyTorch ``nn.Linear`` bias init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.models import ContinuousConvModel
from nbody_sim.models.mlp import Dense, MaskedBatchNorm
from nbody_sim.ops.radius import batched_radius_neighbors


def test_masked_bn_matches_torch_semantics():
    """Train-mode output + running-stat update vs a numpy torch-BatchNorm1d
    oracle (biased var normalisation, unbiased running update, momentum 0.1)."""
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (5, 7, 4)).astype(np.float32)
    mask = rng.uniform(size=(5, 7)) > 0.3
    bn = MaskedBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        mask=jnp.asarray(mask), train=True)
    y, updates = bn.apply(
        variables, jnp.asarray(x), mask=jnp.asarray(mask), train=True,
        mutable=["batch_stats"],
    )

    xv = x[mask]  # (n_valid, 4) — what torch BatchNorm1d would see
    mean = xv.mean(0)
    var = xv.var(0)  # biased, used for normalisation
    want = (x - mean) / np.sqrt(var + 1e-5)  # scale=1, bias=0 at init
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-5)

    n = xv.shape[0]
    want_rmean = 0.9 * 0.0 + 0.1 * mean
    want_rvar = 0.9 * 1.0 + 0.1 * var * n / (n - 1)  # unbiased running update
    np.testing.assert_allclose(
        np.asarray(updates["batch_stats"]["mean"]), want_rmean, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(updates["batch_stats"]["var"]), want_rvar, rtol=1e-5
    )


def test_masked_bn_invariant_to_padding():
    """Appending masked-out rows must change neither outputs on valid rows
    nor the running statistics."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    mask = np.ones((4, 6), bool)
    bn = MaskedBatchNorm()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        mask=jnp.asarray(mask), train=True)
    y0, up0 = bn.apply(variables, jnp.asarray(x), mask=jnp.asarray(mask),
                       train=True, mutable=["batch_stats"])

    x_pad = np.concatenate([x, rng.normal(size=(2, 6, 3)).astype(np.float32)])
    mask_pad = np.concatenate([mask, np.zeros((2, 6), bool)])
    y1, up1 = bn.apply(variables, jnp.asarray(x_pad),
                       mask=jnp.asarray(mask_pad), train=True,
                       mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(y1[:4]), np.asarray(y0),
                               rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(
            np.asarray(up1["batch_stats"][k]),
            np.asarray(up0["batch_stats"][k]), rtol=1e-5,
        )


def test_contconv_train_forward_invariant_to_batch_padding():
    """End-to-end: a contconv train-mode forward (BatchNorm active) gives
    identical valid-node predictions and batch_stats whether or not the batch
    carries padded tail rows — the exact-tail-batch guarantee (no
    wraparound duplication of real rows)."""
    rng = np.random.default_rng(2)
    b, n = 3, 10
    x = rng.normal(size=(b, n, 7)).astype(np.float32) * 0.3
    model = ContinuousConvModel(
        in_channels=4, filter_resolution=(4,), radius=1.0,
        continuous_conv_layers=1, continuous_conv_dim=8,
        encoder_hiddens=(8,), scale_factor=1e6,
    )
    mask = jnp.ones((b, n), bool)
    idx, valid = batched_radius_neighbors(
        jnp.asarray(x[..., :3]), 1.0, k_max=8, mask=mask, include_self=True
    )
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x), idx, valid)
    out0, up0 = model.apply(
        variables, jnp.asarray(x), idx, valid, train=True, node_mask=mask,
        mutable=["batch_stats"],
    )

    # same batch + 2 fully-masked padding rows (arbitrary contents)
    x_pad = np.concatenate([x, rng.normal(size=(2, n, 7)).astype(np.float32)])
    mask_pad = jnp.concatenate([mask, jnp.zeros((2, n), bool)])
    idx_p, valid_p = batched_radius_neighbors(
        jnp.asarray(x_pad[..., :3]), 1.0, k_max=8, mask=mask_pad,
        include_self=True,
    )
    out1, up1 = model.apply(
        variables, jnp.asarray(x_pad), idx_p, valid_p, train=True,
        node_mask=mask_pad, mutable=["batch_stats"],
    )
    np.testing.assert_allclose(
        np.asarray(out1[:b]), np.asarray(out0), rtol=1e-4, atol=1e-6
    )
    s0 = jax.tree_util.tree_leaves(up0["batch_stats"])
    s1 = jax.tree_util.tree_leaves(up1["batch_stats"])
    for a, c in zip(s0, s1):
        np.testing.assert_allclose(np.asarray(c), np.asarray(a), rtol=1e-5)


def test_dense_torch_bias_init():
    """PyTorch nn.Linear bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) —
    non-zero, bounded (flax's stock Dense zero-initialises biases)."""
    fan_in = 64
    dense = Dense(32)
    params = dense.init(jax.random.PRNGKey(0), jnp.zeros((4, fan_in)))
    b = np.asarray(params["params"]["bias"])
    bound = fan_in**-0.5
    assert np.all(np.abs(b) <= bound)
    assert np.std(b) > 0.1 * bound  # actually random, not zeros
    k = np.asarray(params["params"]["kernel"])
    assert np.all(np.abs(k) <= bound + 1e-7)


@pytest.mark.parametrize("mixed", ["bucketed", "mixed", "reference"])
def test_trainer_exact_tail_and_mixed_batches(tmp_path, mixed):
    """Train 2 epochs on a tiny two-size dataset with a batch size that forces
    a partial tail batch; loss must be finite and decrease-ish, and mixed mode
    must pool both sizes into one padded bucket."""
    from nbody_sim.cli.datagen import main as datagen_main
    from nbody_sim.models import GraphModel
    from nbody_sim.train.trainer import Trainer

    out = tmp_path / "train"
    out.mkdir()
    datagen_main([
        "--n-bodies", "4", "7", "--steps", "5", "--sim-type", "disk",
        "--integrator", "leapfrog",
        "--output", str(out / "d.csv"), "--seed", "3",
    ])
    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                       aggr="mean", neighbors=3, scale_factor=1e6)
    trainer = Trainer(model, learning_rate=1e-3, dt=1e-4)
    # 10 snapshots per size; batch 4 -> tail batch of 2 (exact, masked)
    losses, mses = trainer.train_from_dir(
        str(out), epochs=2, batch_size=4, verbose=False,
        batch_mode=mixed,
    )
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(np.isfinite(mses))


def test_reference_mode_loss_matches_mixed_batch_oracle(tmp_path):
    """One 'reference'-mode step's loss == the mixed-batch RMSE over the
    union of its sub-batches, computed by an explicit oracle."""
    import jax.numpy as jnp
    from nbody_sim.models import GraphModel
    from nbody_sim.models.common import scaled_rmse_and_mse
    from nbody_sim.train.graphs import build_graph
    from nbody_sim.train.trainer import Trainer

    rng = np.random.default_rng(5)
    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                       aggr="mean", neighbors=3, scale_factor=1e6)
    trainer = Trainer(model, learning_rate=0.0, dt=1e-4)  # lr=0: no update

    xs, ys, nvs = [], [], []
    for n in (5, 9):
        x = rng.normal(size=(4, n, 7)).astype(np.float32)
        y = (rng.normal(size=(4, n, 3)) * 1e-6).astype(np.float32)
        xs.append(jnp.asarray(x))
        ys.append(jnp.asarray(y))
        nvs.append(jnp.full((4,), n, jnp.int32))

    class _B:  # minimal batch for state init
        pass

    b = _B()
    b.x = np.asarray(xs[0])
    b.node_mask = np.ones((4, 5), bool)
    trainer._ensure_state(b)

    sels = tuple(jnp.asarray([[0, 1]], np.int32) for _ in xs)
    valids = tuple(jnp.asarray([[True, True]]) for _ in xs)
    keys = jax.random.split(jax.random.PRNGKey(0), 1)
    new_state, losses, mses = trainer._train_bucket_multi(
        trainer.state, tuple(xs), tuple(ys), tuple(nvs), sels, valids, keys
    )

    # oracle: masked scaled RMSE over the union of all nodes of both buckets
    # (lr=0 so new_state.params == the params the loss was computed with)
    sse = cnt = 0.0
    for x, y in zip(xs, ys):
        xb, yb = x[:2], y[:2]
        idx, valid = build_graph(model.graph_spec, xb[..., :3])
        pred = model.apply({"params": new_state.params}, xb, idx, valid)
        sse += float(jnp.sum((pred - yb) ** 2))
        cnt += pred.size
    want = 1e6 * np.sqrt(sse / cnt)
    np.testing.assert_allclose(float(losses[0]), want, rtol=1e-5)
