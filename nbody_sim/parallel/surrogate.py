"""Particle-sharded surrogate forward — scaling the GNN force model across
the device mesh (SURVEY.md §2.9b / §5.7: the particle axis is this domain's
sequence axis; ``parallel/ring.py`` shards the O(N^2) direct force the same
way).

Decomposition: shard the N particles over the mesh axis. Node state is small
(positions 12 B/node, features ~30 B/node, hidden 256 B/node), so each layer
all_gathers the *inputs* it must read and computes only its own
shard's outputs:

    x_full   = all_gather(x_shard)                 # (N, 7)   ~3 MB @ 100k
    idx      = kNN(queries = shard, candidates = x_full)      # (Nl, k)
    per EdgeConv layer:
        h_full  = all_gather(h_shard)              # (N, d)   ~26 MB @ 100k
        h_shard = aggr_j MLP([h_i || h_j - h_i])   # only local rows
    head(LayerNorm([enc_shard || h_shard]))        # local rows

This reproduces ``models.gnn.GraphModel.__call__`` /
``models.contconv.ContinuousConvModel.__call__`` exactly by APPLYING the
models' own flax submodules (``EdgeConv``, ``ContinuousConv``, ``MLP``,
``OutputHead``, ``LayerNorm``) with the sliced parameter subtrees — the layer
math lives in ``models/`` only. The one sharding-specific twist is the
``h_src``/``feat_src``/``pos_src`` gather-source arguments those modules
accept: neighbor indices reference the all-gathered full arrays while the
receiver rows are the local shard. CPU-mesh equality tests
(tests/test_sharded_surrogate.py) pin bit-parity with the single-device
forwards.
"""

from __future__ import annotations


import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbody_sim.models.common import select_input_features
from nbody_sim.models.contconv import ContinuousConv, conv_geometry
from nbody_sim.models.gnn import EdgeConv
from nbody_sim.models.mlp import MLP, OutputHead
from nbody_sim.ops.knn import knn_query
from nbody_sim.train.graphs import build_graph


def _shard_knn(model, pos_l, pos_full, me, shard):
    """Per-shard neighbor lists against the gathered positions.

    Two regimes, chosen by the model's own ``graph_spec``:
    - morton: run the O(N·W) curve search *replicated* on the gathered
      positions (same spec as the single-device forward, so the graph is
      bit-identical) and slice this shard's rows. Replicated O(N·W) beats the
      per-shard O(N^2/P) distance matrix from ~(P·W·copies) bodies up —
      ~3e8 vs 1.25e9 ops at 100k on 8 devices.
    - exact (default): asymmetric per-shard query, O(N^2/P) per device.
    """
    kind, kw = model.graph_spec
    if kind == "knn" and kw.get("method") == "morton":
        idx_f, valid_f = build_graph(model.graph_spec, pos_full[None])
        idx = jax.lax.dynamic_slice_in_dim(idx_f[0], me * shard, shard)
        valid = jax.lax.dynamic_slice_in_dim(valid_f[0], me * shard, shard)
        return idx, valid
    return knn_query(
        pos_l, pos_full, model.neighbors, q_offset=me * shard,
        include_self=False,
    )


def _apply_output_scale(model, out):
    """Mirror GraphModel/ContinuousConvModel's trailing output_scale
    division (gnn.py:179-180, contconv.py:306-307) — with output_scale=1e6
    (the large-N training recipe) the net emits scaled targets and apply()
    stays physical; the sharded forwards must divide identically."""
    if model.output_scale != 1.0:
        out = out / jnp.asarray(model.output_scale, out.dtype)
    return out


def _head(model, params, enc_l, h_l):
    """Skip-concat + LayerNorm + decoder + output_scale — the tail shared
    verbatim by both model families (gnn.py:144-148, contconv.py:233-234),
    applied through the models' own modules."""
    out = nn.LayerNorm(epsilon=1e-5).apply(
        {"params": params["LayerNorm_0"]},
        jnp.concatenate([enc_l, h_l], axis=-1),
    )
    hiddens = (model.output_hiddens if hasattr(model, "output_hiddens")
               else model.decoder_hiddens)
    out_dim = (model.output_dim if hasattr(model, "output_dim")
               else model.out_channels)
    out = OutputHead(hiddens, out_dim, zero_init=model.zero_init_output).apply(
        {"params": params["OutputHead_0"]}, out)
    return _apply_output_scale(model, out)


def _gnn_forward_local(model, params, pos_l, vel_l, mass_l, axis, shard):
    """One shard's rows of the GraphModel forward (the body shared by
    predict / rollout / training-grad): all_gather inputs, compute local
    outputs by applying the model's own submodules with the matching
    parameter subtrees (``h_src`` = the gathered full feature array)."""
    me = jax.lax.axis_index(axis)
    x_l = jnp.concatenate([pos_l, vel_l, mass_l[:, None]], axis=-1)
    x_full = jax.lax.all_gather(x_l, axis, tiled=True)  # (N, 7)

    idx, valid = _shard_knn(model, pos_l, x_full[:, :3], me, shard)

    h_full = select_input_features(x_full, model.input_dim)
    h_l = select_input_features(x_l, model.input_dim)
    if model.node_encoder_dims:
        h_full = MLP(
            tuple(model.node_encoder_dims) + (model.gnn_dim,),
            dropout=model.encoder_dropout, norm=None,
        ).apply({"params": params["MLP_0"]}, h_full)
        h_l = jax.lax.dynamic_slice_in_dim(h_full, me * shard, shard)
    enc_l = h_l

    conv_cls = nn.remat(EdgeConv) if model.remat else EdgeConv
    for li in range(model.message_passing_steps):
        h_l = conv_cls(model.gnn_dim, model.aggr, model.fused_edgeconv).apply(
            {"params": params[f"EdgeConv_{li}"]},
            h_l[None], idx[None], valid[None], h_src=h_full[None],
        )[0]
        if li < model.message_passing_steps - 1:
            h_full = jax.lax.all_gather(h_l, axis, tiled=True)

    return _head(model, params, enc_l, h_l)


def sharded_predict(model, variables, pos, vel, mass, mesh: Mesh,
                    axis: str = "particles"):
    """Surrogate acceleration prediction with the particle axis sharded over
    ``mesh``'s ``axis`` — the multi-device counterpart of
    ``train.rollout.predict_accelerations``.

    :param model: a ``GraphModel`` (``aggr``, ``neighbors``,
        ``message_passing_steps``, ``input_dim`` are read from it).
    :param variables: its parameter tree ({"params": ...}).
    :param pos/vel: (N, 3); :param mass: (N,). N must divide the axis size.
    :return: (N, 3) accelerations, sharded over ``axis``.
    """
    params = variables["params"]
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0, f"N={n} must divide the {axis!r} axis ({n_dev})"
    shard = n // n_dev

    def fwd(pos_l, vel_l, mass_l):
        return _gnn_forward_local(model, params, pos_l, vel_l, mass_l,
                                  axis, shard)

    spec = P(axis)
    fn = jax.jit(
        jax.shard_map(
            fwd, mesh=mesh,
            in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False,  # Pallas morton path runs replicated inside
        )
    )
    sharding = NamedSharding(mesh, spec)
    return fn(
        jax.device_put(pos, sharding),
        jax.device_put(vel, sharding),
        jax.device_put(mass, sharding),
    )


def _contconv_forward_local(model, params, bstats, pos_l, vel_l, mass_l,
                            axis, shard, train=False):
    """One shard's rows of the ContinuousConvModel forward: radius graph per
    query shard against the all-gathered positions, each conv layer
    all_gathers its input features and is applied through the model's own
    ``ContinuousConv`` module (``feat_src`` = the gathered full features).

    ``train=True`` runs the encoder BatchNorm in batch-statistics mode on
    the REPLICATED full node array — exactly the statistics the
    single-device forward computes over the same (1, N) batch — and returns
    ``(out_l, new_bstats)`` so the sharded training step can carry the
    running stats. Eval mode returns ``out_l`` only.
    """
    if train:
        assert (model.encoder_dropout == 0.0
                and model.continuous_conv_dropout == 0.0), (
            "sharded training does not thread dropout RNGs")
    resolutions = model._resolutions()
    me = jax.lax.axis_index(axis)
    x_l = jnp.concatenate([pos_l, vel_l, mass_l[:, None]], axis=-1)
    x_full = jax.lax.all_gather(x_l, axis, tiled=True)
    pos_full = x_full[:, :3]
    k_max = min(model.radius_kmax, pos_full.shape[0])

    kind, kw = model.graph_spec
    if kw.get("method") == "morton":
        # replicated O(N·W) radius search (cutoff applied inside),
        # sliced to this shard — same spec as the single-device forward
        idx_f, valid_f = build_graph(model.graph_spec, pos_full[None])
        idx = jax.lax.dynamic_slice_in_dim(idx_f[0], me * shard, shard)
        valid = jax.lax.dynamic_slice_in_dim(valid_f[0], me * shard, shard)
    else:
        idx, valid = knn_query(
            pos_l, pos_full, k_max, q_offset=me * shard,
            include_self=model.self_loops,
        )
        d2_sel = jnp.sum(
            (pos_full[idx] - pos_l[:, None, :]) ** 2, axis=-1
        )
        valid = valid & (d2_sel < jnp.asarray(model.radius) ** 2)
        idx = jnp.where(valid, idx, 0)

    h_full = select_input_features(x_full, model.in_channels)
    new_bstats = bstats
    if model.encoder_hiddens:
        enc = MLP(
            tuple(model.encoder_hiddens) + (model.continuous_conv_dim,),
            dropout=model.encoder_dropout, norm="batch_norm",
        )
        enc_vars = {"params": params["MLP_0"],
                    "batch_stats": bstats["MLP_0"]}
        if train:
            h_full, mut = enc.apply(enc_vars, h_full[None], train=True,
                                    mutable=["batch_stats"])
            h_full = h_full[0]
            new_bstats = {"MLP_0": mut["batch_stats"]}
        else:
            h_full = enc.apply(enc_vars, h_full[None])[0]
    h_l = jax.lax.dynamic_slice_in_dim(h_full, me * shard, shard)
    enc_l = h_l

    geom = conv_geometry(pos_l[None], idx[None], valid[None], model.radius,
                         pos_src=pos_full[None])
    for li in range(model.continuous_conv_layers):
        ci = (
            model.in_channels
            if (li == 0 and not model.encoder_hiddens)
            else model.continuous_conv_dim
        )
        h_l = jnp.tanh(
            ContinuousConv(
                in_channels=ci,
                out_channels=model.continuous_conv_dim,
                filter_resolution=resolutions[li],
                radius=model.radius,
                agg=model.agg,
            ).apply(
                {"params": params[f"ContinuousConv_{li}"]},
                pos_l[None], h_l[None], idx[None], valid[None],
                geom=geom, feat_src=h_full[None],
            )[0]
        )
        if li < model.continuous_conv_layers - 1:
            h_full = jax.lax.all_gather(h_l, axis, tiled=True)

    out = _head(model, params, enc_l, h_l)
    return (out, new_bstats) if train else out


def sharded_contconv_predict(model, variables, pos, vel, mass, mesh: Mesh,
                             axis: str = "particles"):
    """Particle-sharded ContinuousConvModel prediction (eval mode): the
    radius graph is built per query shard against the all-gathered positions
    and each conv layer all_gathers its input features — the contconv
    counterpart of :func:`sharded_predict`. Mirrors
    ``models.contconv.ContinuousConvModel.__call__``; the CPU-mesh equality
    test is the guard."""
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0
    shard = n // n_dev

    def fwd(pos_l, vel_l, mass_l):
        return _contconv_forward_local(model, params, bstats, pos_l, vel_l,
                                       mass_l, axis, shard)

    spec = P(axis)
    fn = jax.jit(
        jax.shard_map(fwd, mesh=mesh, in_specs=(spec, spec, spec),
                      out_specs=spec, check_vma=False)
    )
    sharding = NamedSharding(mesh, spec)
    return fn(
        jax.device_put(pos, sharding),
        jax.device_put(vel, sharding),
        jax.device_put(mass, sharding),
    )


def sharded_rollout(model, variables, pos0, vel0, mass, steps: int, dt: float,
                    mesh: Mesh, axis: str = "particles"):
    """Particle-sharded autoregressive leapfrog rollout (KDK with the learned
    force, semantics of ``train.rollout.autoregressive_rollout``): the whole
    trajectory stays sharded; one ``lax.scan`` per call.

    :return: (pos, vel, acc) each (steps, N, 3), row 0 = seed state with its
        predicted acceleration.
    """
    params = variables["params"]
    n = pos0.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0
    shard = n // n_dev

    def predict_local(pos_l, vel_l, mass_l):
        return _gnn_forward_local(model, params, pos_l, vel_l, mass_l,
                                  axis, shard)

    def body(pos_l, vel_l, mass_l):
        acc0 = predict_local(pos_l, vel_l, mass_l)

        def step(carry, _):
            p, v, a = carry
            v_half = v + 0.5 * dt * a
            p_n = p + dt * v_half
            a_n = predict_local(p_n, v_half, mass_l)
            v_n = v_half + 0.5 * dt * a_n
            return (p_n, v_n, a_n), (p_n, v_n, a_n)

        _, (ps, vs, accs) = jax.lax.scan(
            step, (pos_l, vel_l, acc0), None, length=steps - 1
        )
        ps = jnp.concatenate([pos_l[None], ps], axis=0)
        vs = jnp.concatenate([vel_l[None], vs], axis=0)
        accs = jnp.concatenate([acc0[None], accs], axis=0)
        return ps, vs, accs

    spec_in = P(axis)
    spec_out = P(None, axis)
    fn = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(spec_in, spec_in, spec_in),
            out_specs=(spec_out, spec_out, spec_out),
            check_vma=False,  # Pallas morton path runs replicated inside
        )
    )
    sharding = NamedSharding(mesh, spec_in)
    return fn(
        jax.device_put(pos0, sharding),
        jax.device_put(vel0, sharding),
        jax.device_put(mass, sharding),
    )


def _sharded_rmse_step(local_sse, params, inputs, n, mesh, axis,
                       has_aux=False):
    """Shared scaffolding of the sharded training steps: differentiate the
    LOCAL sum of squares only — no psum inside the AD path (psum transposes
    to psum under shard_map, which would scale every cotangent by n_dev).
    The all_gathers inside the forward transpose to reduce-scatters as
    usual. Then reduce the partials and apply the sqrt chain rule
    explicitly:

        L = sqrt(S / (3n)),  dL/dp = psum(dS_local/dp) / (2 * 3n * L)

    :param local_sse: f(params, pos_l, vel_l, mass_l, y_l) -> sse scalar
        (or (sse, aux) with ``has_aux``).
    :param inputs: (pos, vel, mass, y) full arrays to shard.
    :return: (loss, grads[, aux]) — loss a replicated scalar, grads a
        params-tree of replicated full gradients.
    """

    def step(p, pos_l, vel_l, mass_l, y_l):
        out = jax.value_and_grad(local_sse, has_aux=has_aux)(
            p, pos_l, vel_l, mass_l, y_l)
        if has_aux:
            (sse_l, aux), g_l = out
        else:
            sse_l, g_l = out
        total = jax.lax.psum(sse_l, axis)
        loss = jnp.sqrt(total / (n * 3))
        coef = 0.5 / jnp.maximum(loss * (n * 3), 1e-30)
        g = jax.tree_util.tree_map(
            lambda t: jax.lax.psum(t, axis) * coef, g_l)
        return (loss, g, aux) if has_aux else (loss, g)

    spec = P(axis)
    out_specs = (P(), P(), P()) if has_aux else (P(), P())
    fn = jax.jit(
        jax.shard_map(
            step, mesh=mesh,
            in_specs=(P(), spec, spec, spec, spec),
            out_specs=out_specs,
            check_vma=False,  # Pallas morton path runs replicated inside
        )
    )
    sharding = NamedSharding(mesh, spec)
    return fn(params, *(jax.device_put(a, sharding) for a in inputs))


def sharded_loss_and_grad(model, variables, pos, vel, mass, y, mesh: Mesh,
                          axis: str = "particles"):
    """Particle-sharded training-step core: the reference's scaled-RMSE
    loss (gnn.py:150-161) and its parameter gradients with the N axis
    sharded over ``mesh`` — ``jax.grad`` straight THROUGH the sharded
    forward. The all_gathers differentiate into collectives automatically
    and each shard's parameter-gradient contribution is psum'd, so the
    result equals the single-device gradient (CPU-mesh test:
    tests/test_sharded_surrogate.py). Combined with BH ground-truth
    datagen this is the path to training at N where a single chip's
    (N, k, d) activations don't fit.

    :param y: (N, 3) target accelerations, sharded like ``pos``.
    :return: (loss, grads) — loss a replicated scalar, grads a params-tree
        of replicated full gradients.
    """
    assert model.encoder_dropout == 0.0, (
        "sharded training does not thread dropout RNGs — "
        "_gnn_forward_local applies the encoder deterministically")
    params = variables["params"]
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0, f"N={n} must divide the {axis!r} axis ({n_dev})"
    shard = n // n_dev
    scale = jnp.float32(model.scale_factor)

    def local_sse(p, pos_l, vel_l, mass_l, y_l):
        pred_l = _gnn_forward_local(model, p, pos_l, vel_l, mass_l, axis,
                                    shard)
        return jnp.sum((scale * (pred_l - y_l)) ** 2)

    return _sharded_rmse_step(local_sse, params, (pos, vel, mass, y), n,
                              mesh, axis)


def sharded_contconv_loss_and_grad(model, variables, pos, vel, mass, y,
                                   mesh: Mesh, axis: str = "particles"):
    """The ContConv twin of :func:`sharded_loss_and_grad`:
    scaled-RMSE loss + parameter gradients through the particle-sharded
    ContinuousConvModel forward in TRAIN mode — encoder BatchNorm batch
    statistics are computed on the replicated full node array (identical to
    the single-device statistics over the same batch) and the updated
    running stats are returned so a training loop can carry them.

    This is the path to ContConv training at N where one device's
    activations don't fit.

    :return: (loss, grads, new_batch_stats) — all replicated.
    """
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0, f"N={n} must divide the {axis!r} axis ({n_dev})"
    shard = n // n_dev
    scale = jnp.float32(model.scale_factor)

    def local_sse(p, pos_l, vel_l, mass_l, y_l):
        pred_l, new_bs = _contconv_forward_local(
            model, p, bstats, pos_l, vel_l, mass_l, axis, shard, train=True)
        return jnp.sum((scale * (pred_l - y_l)) ** 2), new_bs

    return _sharded_rmse_step(local_sse, params, (pos, vel, mass, y), n,
                              mesh, axis, has_aux=True)


def sharded_contconv_rollout(model, variables, pos0, vel0, mass, steps: int,
                             dt: float, mesh: Mesh,
                             axis: str = "particles"):
    """Particle-sharded autoregressive rollout with the ContConv surrogate
    force — the contconv twin of :func:`sharded_rollout` (same KDK
    semantics; radius graphs rebuilt from predicted positions on device
    every step).

    :return: (pos, vel, acc) each (steps, N, 3), row 0 = seed state.
    """
    params = variables["params"]
    bstats = variables.get("batch_stats", {})
    n = pos0.shape[0]
    n_dev = mesh.shape[axis]
    assert n % n_dev == 0
    shard = n // n_dev

    def predict_local(pos_l, vel_l, mass_l):
        return _contconv_forward_local(model, params, bstats, pos_l, vel_l,
                                       mass_l, axis, shard)

    def body(pos_l, vel_l, mass_l):
        acc0 = predict_local(pos_l, vel_l, mass_l)

        def step(carry, _):
            p, v, a = carry
            v_half = v + 0.5 * dt * a
            p_n = p + dt * v_half
            a_n = predict_local(p_n, v_half, mass_l)
            v_n = v_half + 0.5 * dt * a_n
            return (p_n, v_n, a_n), (p_n, v_n, a_n)

        _, (ps, vs, accs) = jax.lax.scan(
            step, (pos_l, vel_l, acc0), None, length=steps - 1
        )
        ps = jnp.concatenate([pos_l[None], ps], axis=0)
        vs = jnp.concatenate([vel_l[None], vs], axis=0)
        accs = jnp.concatenate([acc0[None], accs], axis=0)
        return ps, vs, accs

    spec_in = P(axis)
    spec_out = P(None, axis)
    fn = jax.jit(
        jax.shard_map(
            body, mesh=mesh,
            in_specs=(spec_in, spec_in, spec_in),
            out_specs=(spec_out, spec_out, spec_out),
            check_vma=False,
        )
    )
    sharding = NamedSharding(mesh, spec_in)
    return fn(
        jax.device_put(pos0, sharding),
        jax.device_put(vel0, sharding),
        jax.device_put(mass, sharding),
    )
