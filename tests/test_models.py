"""Surrogate models vs hand-rolled oracles of the reference architecture
(``/root/reference/gnn.py``, ``/root/reference/contconv.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.models import GraphModel, ContinuousConvModel
from nbody_sim.models.common import scaled_rmse_and_mse
from nbody_sim.models.contconv import ball_to_cube, ContinuousConv
from nbody_sim.ops.knn import batched_knn_neighbors
from nbody_sim.ops.radius import batched_radius_neighbors
from nbody_sim.ops.interpolate import trilinear_interpolate


def _batch(b=2, n=20, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, n, 3)).astype(np.float32)
    vel = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.1
    mass = rng.uniform(0.1, 1, size=(b, n, 1)).astype(np.float32)
    x = np.concatenate([pos, vel, mass], axis=-1)
    y = rng.normal(size=(b, n, 3)).astype(np.float32) * 1e-6
    return jnp.asarray(x), jnp.asarray(y)


def test_graph_model_forward_shapes_and_determinism():
    x, _ = _batch()
    model = GraphModel(input_dim=4, gnn_dim=32, message_passing_steps=2,
                       aggr="mean", neighbors=5, scale_factor=1e6)
    idx, valid = batched_knn_neighbors(x[..., :3], 5)
    params = model.init(jax.random.PRNGKey(0), x, idx, valid)
    out = model.apply(params, x, idx, valid)
    assert out.shape == (2, 20, 3)
    out2 = model.apply(params, x, idx, valid)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))


def test_graph_model_matches_manual_edgeconv():
    """One EdgeConv stack vs an explicit per-edge loop oracle."""
    x, _ = _batch(b=1, n=10, seed=1)
    k = 4
    model = GraphModel(input_dim=7, gnn_dim=8, message_passing_steps=1,
                       aggr="sum", neighbors=k)
    idx, valid = batched_knn_neighbors(x[..., :3], k)
    params = model.init(jax.random.PRNGKey(1), x, idx, valid)
    out = np.asarray(model.apply(params, x, idx, valid))

    p = jax.tree_util.tree_map(np.asarray, params["params"])
    w0, b0 = p["EdgeConv_0"]["Dense_0"]["kernel"], p["EdgeConv_0"]["Dense_0"]["bias"]
    w1, b1 = p["EdgeConv_0"]["Dense_1"]["kernel"], p["EdgeConv_0"]["Dense_1"]["bias"]
    ln_s, ln_b = p["LayerNorm_0"]["scale"], p["LayerNorm_0"]["bias"]
    wo, bo = p["OutputHead_0"]["Dense_0"]["kernel"], p["OutputHead_0"]["Dense_0"]["bias"]

    xb = np.asarray(x)[0]
    idxb, validb = np.asarray(idx)[0], np.asarray(valid)[0]
    h = np.zeros((10, 8), np.float64)
    for i in range(10):
        for j_slot in range(k):
            if validb[i, j_slot]:
                j = idxb[i, j_slot]
                m = np.concatenate([xb[i], xb[j] - xb[i]])
                e = np.tanh(m @ w0 + b0) @ w1 + b1
                h[i] += e
    cat = np.concatenate([xb, h], axis=-1)
    mu, var = cat.mean(-1, keepdims=True), cat.var(-1, keepdims=True)
    normed = (cat - mu) / np.sqrt(var + 1e-5) * ln_s + ln_b
    want = normed @ wo + bo
    np.testing.assert_allclose(out[0], want, rtol=1e-4, atol=1e-5)


def test_graph_model_padding_invariance():
    """Padded snapshots must give identical predictions on valid nodes."""
    x, _ = _batch(b=1, n=16, seed=2)
    model = GraphModel(input_dim=4, gnn_dim=16, message_passing_steps=2,
                       aggr="mean", neighbors=4)
    idx, valid = batched_knn_neighbors(x[..., :3], 4)
    params = model.init(jax.random.PRNGKey(2), x, idx, valid)
    out = model.apply(params, x, idx, valid)

    x_pad = jnp.concatenate([x, jnp.ones((1, 6, 7))], axis=1)
    mask = jnp.arange(22)[None, :] < 16
    idx_p, valid_p = batched_knn_neighbors(x_pad[..., :3], 4, mask=mask)
    out_p = model.apply(params, x_pad, idx_p, valid_p)
    np.testing.assert_allclose(
        np.asarray(out_p[:, :16]), np.asarray(out), rtol=1e-5, atol=1e-6
    )


def test_ball_to_cube_matches_reference():
    rng = np.random.default_rng(3)
    r = rng.normal(size=(30, 3)).astype(np.float32)
    got = np.asarray(ball_to_cube(jnp.asarray(r)))
    norm = np.linalg.norm(r, axis=-1, keepdims=True)
    want = r / (norm + 1e-8) * np.tanh(norm)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(got) < 1.0)


@pytest.mark.parametrize("agg", ["mean", "sum"])
def test_contconv_layer_matches_gather_oracle(agg):
    """Collect-then-matmul formulation == per-edge interpolate-gather-einsum
    (the reference's computation order, contconv.py:80-98)."""
    b, n, k, ci, co, d, radius = 2, 12, 6, 3, 5, 4, 1.2
    rng = np.random.default_rng(4)
    pos = jnp.asarray(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32))
    feat = jnp.asarray(rng.normal(size=(b, n, ci)).astype(np.float32))
    idx, valid = batched_radius_neighbors(pos, radius, k_max=k, include_self=True)

    layer = ContinuousConv(in_channels=ci, out_channels=co,
                           filter_resolution=d, radius=radius, agg=agg)
    params = layer.init(jax.random.PRNGKey(4), pos, feat, idx, valid)
    out = np.asarray(layer.apply(params, pos, feat, idx, valid))

    filters = jnp.asarray(params["params"]["filters"])
    for bb in range(b):
        for i in range(n):
            acc = np.zeros(co)
            cnt = 0
            for s in range(k):
                if not bool(valid[bb, i, s]):
                    continue
                j = int(idx[bb, i, s])
                r = np.asarray(pos[bb, j] - pos[bb, i])
                d2 = float((r**2).sum())
                if d2 >= radius**2:
                    continue
                window = (1 - d2 / radius**2) ** 3
                mapped = np.asarray(ball_to_cube(jnp.asarray(r[None]))[0])
                coords = (mapped + 1) * ((d - 1) / 2)
                filt = np.asarray(
                    trilinear_interpolate(filters, jnp.asarray(coords[None]))
                )[0]  # (ci, co)
                acc += window * (np.asarray(feat[bb, j]) @ filt)
                cnt += 1
            if agg == "mean" and cnt > 0:
                acc /= cnt
            np.testing.assert_allclose(out[bb, i], acc, rtol=1e-3, atol=1e-5)


def test_contconv_model_forward():
    x, _ = _batch(b=2, n=15, seed=5)
    model = ContinuousConvModel(
        in_channels=4, out_channels=3, filter_resolution=(4, 3), radius=1.0,
        agg="mean", self_loops=True, continuous_conv_layers=2,
        continuous_conv_dim=16, encoder_hiddens=(8, 8),
        decoder_hiddens=(8,), scale_factor=1e6,
    )
    kind, kw = model.graph_spec
    assert kind == "radius"
    idx, valid = batched_radius_neighbors(
        x[..., :3], kw["radius"], k_max=kw["k_max"], include_self=kw["include_self"]
    )
    variables = model.init(jax.random.PRNGKey(5), x, idx, valid)
    assert "batch_stats" in variables  # contconv encoder keeps PyG batch_norm
    out = model.apply(variables, x, idx, valid)
    assert out.shape == (2, 15, 3)
    # train-mode call mutates batch_stats
    out_t, updates = model.apply(
        variables, x, idx, valid, train=True, mutable=["batch_stats"]
    )
    assert "batch_stats" in updates


def test_scaled_rmse_matches_reference_formula():
    rng = np.random.default_rng(6)
    pred = rng.normal(size=(2, 10, 3)).astype(np.float32) * 1e-6
    y = rng.normal(size=(2, 10, 3)).astype(np.float32) * 1e-6
    s = 1e6
    loss, mse = scaled_rmse_and_mse(jnp.asarray(pred), jnp.asarray(y), s)
    want_mse = ((pred - y) ** 2).mean()
    want_loss = np.sqrt(((pred * s - y * s) ** 2).mean())
    assert abs(float(mse) - want_mse) < 1e-12
    assert abs(float(loss) - want_loss) < 1e-5 * want_loss

    # masked version == unpadded computation
    mask = np.zeros((2, 10), bool); mask[:, :7] = True
    loss_m, mse_m = scaled_rmse_and_mse(
        jnp.asarray(pred), jnp.asarray(y), s, node_mask=jnp.asarray(mask)
    )
    want_mse_m = ((pred[:, :7] - y[:, :7]) ** 2).mean()
    assert abs(float(mse_m) - want_mse_m) < 1e-12


def test_zero_init_output_starts_at_zero():
    x, _ = _batch(b=1, n=12, seed=9)
    model = GraphModel(input_dim=4, gnn_dim=8, message_passing_steps=1,
                       aggr="mean", neighbors=4, zero_init_output=True)
    idx, valid = batched_knn_neighbors(x[..., :3], 4)
    params = model.init(jax.random.PRNGKey(9), x, idx, valid)
    out = model.apply(params, x, idx, valid)
    assert float(jnp.abs(out).max()) == 0.0


def test_contconv_empty_encoder_hiddens():
    x, _ = _batch(b=1, n=10, seed=10)
    model = ContinuousConvModel(in_channels=4, out_channels=3,
                                filter_resolution=(3,), radius=1.0,
                                continuous_conv_layers=1,
                                continuous_conv_dim=8, encoder_hiddens=())
    idx, valid = batched_radius_neighbors(x[..., :3], 1.0, k_max=6)
    variables = model.init(jax.random.PRNGKey(10), x, idx, valid)
    out = model.apply(variables, x, idx, valid)
    assert out.shape == (1, 10, 3)


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_fused_edgeconv_matches_unfused(aggr):
    """``fused_edgeconv=True`` is a forward restructure, not a different
    model: identical param tree, same function (rounding-level deltas),
    including nodes whose neighbor slots are all invalid."""
    x, _ = _batch()
    idx, valid = batched_knn_neighbors(x[..., :3], 5)
    # knock out every neighbor of node 0 in batch 0 to hit the
    # zero-valid-neighbor path
    valid = valid.at[0, 0, :].set(False)
    kwargs = dict(input_dim=4, gnn_dim=32, message_passing_steps=2,
                  aggr=aggr, neighbors=5, scale_factor=1e6)
    ref = GraphModel(**kwargs)
    fused = GraphModel(fused_edgeconv=True, **kwargs)
    params = ref.init(jax.random.PRNGKey(0), x, idx, valid)
    # same param tree: fused init must produce the identical structure
    p2 = fused.init(jax.random.PRNGKey(0), x, idx, valid)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(p2)
    out_ref = ref.apply(params, x, idx, valid)
    out_fused = fused.apply(params, x, idx, valid)
    np.testing.assert_allclose(
        np.asarray(out_fused), np.asarray(out_ref), rtol=2e-4, atol=2e-5
    )


def test_remat_same_params_loss_and_grads():
    """``remat=True`` changes only what the backward pass stores (EdgeConv
    intermediates recomputed, not saved): identical param tree (explicit
    layer names defeat nn.remat's CheckpointEdgeConv_i auto-naming),
    bit-identical loss and gradients."""
    x, _ = _batch()
    idx, valid = batched_knn_neighbors(x[..., :3], 5)
    kwargs = dict(input_dim=4, gnn_dim=32, message_passing_steps=2,
                  aggr="mean", neighbors=5, scale_factor=1e6,
                  fused_edgeconv=True, output_scale=1e6)
    ref = GraphModel(**kwargs)
    rem = GraphModel(remat=True, **kwargs)
    params = ref.init(jax.random.PRNGKey(0), x, idx, valid)
    p2 = rem.init(jax.random.PRNGKey(0), x, idx, valid)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(p2))

    def loss(m):
        return lambda p: jnp.sum(m.apply(p, x, idx, valid) ** 2) * 1e12

    l0, g0 = jax.value_and_grad(loss(ref))(params)
    l1, g1 = jax.value_and_grad(loss(rem))(params)
    assert l0 == l1
    deltas = jax.tree_util.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))), g0, g1)
    assert max(jax.tree_util.tree_leaves(deltas)) == 0.0


@pytest.mark.parametrize("cls", [GraphModel, ContinuousConvModel])
def test_output_scale_semantics(cls):
    """output_scale divides the net's raw output so apply() stays in
    physical units: same params at scale s vs 1.0 differ by exactly 1/s,
    and zero_init_output still yields exactly zero. (The scale exists
    because Adam's scale-free steps cannot hold the ~1e-9 weight
    magnitudes that raw ~1e-7-magnitude targets require — see
    models/gnn.py.)"""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(1, 12, 7)).astype(np.float32))
    k = 3
    idx = jnp.asarray(rng.integers(0, 12, (1, 12, k)).astype(np.int32))
    valid = jnp.ones((1, 12, k), bool)
    if cls is GraphModel:
        kw = dict(input_dim=4, gnn_dim=8, message_passing_steps=1,
                  neighbors=k, scale_factor=1e6)
    else:
        kw = dict(in_channels=4, out_channels=3, filter_resolution=(3,),
                  radius=1.0, continuous_conv_layers=1,
                  continuous_conv_dim=8, encoder_hiddens=(8,),
                  decoder_hiddens=(8,), scale_factor=1e6)
    m1 = cls(**kw, output_scale=1.0)
    ms = cls(**kw, output_scale=1e6)
    variables = m1.init(jax.random.PRNGKey(1), x, idx, valid)
    o1 = np.asarray(m1.apply(variables, x, idx, valid))
    os_ = np.asarray(ms.apply(variables, x, idx, valid))
    np.testing.assert_allclose(os_ * 1e6, o1, rtol=1e-6)

    mz = cls(**kw, output_scale=1e6, zero_init_output=True)
    vz = mz.init(jax.random.PRNGKey(1), x, idx, valid)
    assert float(np.abs(np.asarray(mz.apply(vz, x, idx, valid))).max()) == 0.0
