"""EdgeConv message-passing surrogate — static-shape rebuild of the reference
``GraphModel`` (``/root/reference/gnn.py:25-161``).

Architecture parity (gnn.py:56-148): optional tanh-MLP node encoder, a stack
of EdgeConv layers (edge MLP ``Linear(2d->d) -> Tanh -> Linear(d->d)``,
sum/mean aggregation), skip-concat of the encoder output with the GNN output,
LayerNorm, linear-or-MLP decoder. ``input_dim == 4`` selects [pos | mass]
from the 7-dim node features (gnn.py:131-134).

Static-shape representation: instead of a COO edge_index + native scatter
(torch-cluster/torch-scatter), messages live in dense (B, N, k, .) arrays —
gather neighbors, run the edge MLP as one big matmul, masked-reduce over k
(SURVEY.md §2.9a). Known reference bugs NOT replicated: ``GraphModel.step``
calling nonexistent ``self.model.predict`` (gnn.py:229) and ``rollout``
logging stale velocities (gnn.py:250) — the working rollout lives in
``nbody_sim.train.rollout``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from nbody_sim.models.common import gather_neighbors, select_input_features
from nbody_sim.models.mlp import MLP, Dense, OutputHead
from nbody_sim.ops.segment import masked_aggregate


class EdgeConv(nn.Module):
    """PyG ``EdgeConv`` on dense neighbor lists: for every node i,
    aggr_j MLP([h_i || h_j - h_i]) over its k (masked) neighbors.

    ``fused=True`` computes the same function with the per-edge work
    restructured to avoid every (N, k, .)-sized intermediate except one:

        W1^T [h_i || h_j - h_i] + b1  =  u_i + v_j - b1
            with u = d1([h || -h]),  v = d1([0 || h])   (node-sized matmuls)

    and the second Dense commutes past the neighbor reduction
    (mean_j(t_j W2 + b2) = (mean_j t_j) W2 + b2; the sum case adds the
    (count-1)·b2 correction). Only the (B, N, k, dim) gather of ``v``
    remains k-sized (the concat path is memory-bound on the (N, k, 2d)
    message tensor; matmul cost is negligible either way). Parameters and
    the function computed are identical to the unfused path (same flax
    param tree; max output delta ~1e-7 from summation-order rounding)."""

    dim: int
    aggr: str = "sum"
    fused: bool = False

    @nn.compact
    def __call__(self, h, nbr_idx, nbr_valid, h_src=None):
        """:param h_src: optional separate gather source for neighbor
        features (``nbr_idx`` indexes into it). Defaults to ``h`` — the
        single-device case. The particle-sharded forward
        (``parallel/surrogate.py``) passes the all-gathered full array here
        while ``h`` holds only the local shard's rows, so the sharded path
        applies THIS module instead of hand-mirroring its math."""
        src = h if h_src is None else h_src
        d1 = Dense(self.dim)
        d2 = Dense(self.dim)
        if not self.fused:
            h_j = gather_neighbors(src, nbr_idx)  # (B, N, k, d)
            h_i = h[:, :, None, :]
            msg_in = jnp.concatenate(
                [jnp.broadcast_to(h_i, h_j.shape), h_j - h_i], axis=-1
            )
            e = d1(msg_in)
            e = jnp.tanh(e)
            e = d2(e)
            return masked_aggregate(e, nbr_valid, self.aggr, axis=2)

        zeros = jnp.zeros_like(src)
        u = d1(jnp.concatenate([h, -h], axis=-1))        # h @ (W1a-W1b) + b1
        v = d1(jnp.concatenate([zeros, src], axis=-1))   # src @ W1b + b1
        b1 = d1(jnp.zeros((1, 1, 2 * h.shape[-1]), h.dtype))  # (1, 1, dim)
        v_j = gather_neighbors(v, nbr_idx)               # (B, N, k, dim)
        t = jnp.tanh(u[:, :, None, :] + v_j - b1[:, None])
        agg = masked_aggregate(t, nbr_valid, self.aggr, axis=2)
        out = d2(agg)
        b2 = d2(jnp.zeros((1, 1, self.dim), h.dtype))
        cnt = jnp.sum(nbr_valid.astype(h.dtype), axis=2)[..., None]
        if self.aggr == "sum":
            out = out + (cnt - 1.0) * b2
        else:
            # zero-valid-neighbor nodes aggregate to 0 in the unfused path
            # (masked_mean's 0/1), not to b2
            out = jnp.where(cnt > 0, out, 0.0)
        return out


class GraphModel(nn.Module):
    """Reference ctor parity (gnn.py:26-53); ``neighbors`` is the kNN degree
    used to build graphs for this model (datautils.py:36 / trainer.py:65)."""

    input_dim: int = 1
    output_hiddens: Optional[Tuple[int, ...]] = None
    output_dim: int = 3
    node_encoder_dims: Optional[Tuple[int, ...]] = None
    gnn_dim: int = 128
    encoder_dropout: float = 0.0
    message_passing_steps: int = 4
    aggr: str = "sum"
    neighbors: int = 50
    scale_factor: float = 1.0
    zero_init_output: bool = False
    output_scale: float = 1.0  # the net's raw output is divided by this,
    # so with output_scale=1e6 the trainable weights produce O(0.1)-scale
    # values for ~1e-7-magnitude acceleration targets. Without it, Adam's
    # scale-free steps (~lr per weight) can never settle at the ~1e-9
    # weight magnitudes raw targets require — measured at 20k bodies the
    # raw-target model trains to 6000x WORSE than predicting zero (the
    # reference has the same pathology at 500 bodies: its converged
    # scaled loss ~= its predict-zero baseline).
    # apply() still returns physical accelerations.
    knn_approx: bool = False  # legacy alias for knn_method="approx"
    knn_method: Optional[str] = None  # None/"exact" | "approx" | "morton";
    # "morton" is the O(N·W) large-N search (ops/spatial.py) that makes
    # surrogate rollouts beat the direct-sum kernel at 20k+ bodies
    knn_window: int = 64  # morton candidate half-window per curve
    knn_copies: int = 4  # morton curve copies (fewer = faster, lower recall)
    knn_block: int = 256  # morton block rows
    fused_edgeconv: bool = False  # restructured EdgeConv forward (same
    # function & params, ~2x fewer memory-bound (N,k,.) intermediates — see
    # EdgeConv docstring). Off by default so committed training runs
    # reproduce bit-for-bit; rollout/crossover paths turn it on.
    remat: bool = False  # rematerialize each EdgeConv in the backward pass
    # instead of saving its (N, k, dim) intermediates — the knob that fits
    # 1M-body *training* on one chip (saved residuals drop to the (N, dim)
    # layer inputs; forward is recomputed once per layer in the backward).

    @property
    def graph_spec(self):
        """How the data pipeline must build neighbor lists for this model."""
        method = self.knn_method or ("approx" if self.knn_approx else "exact")
        spec = {"k": self.neighbors, "include_self": False, "method": method}
        if method == "morton":
            spec["window"] = self.knn_window
            spec["block"] = self.knn_block
            spec["n_copies"] = self.knn_copies
        return ("knn", spec)

    @nn.compact
    def __call__(self, x, nbr_idx, nbr_valid, train: bool = False,
                 node_mask=None):
        """:param x: (B, N, 7) node features [pos | vel | mass].
        :param nbr_idx: (B, N, k) int32 neighbor indices.
        :param nbr_valid: (B, N, k) bool neighbor validity.
        :param node_mask: optional (B, N) validity for padded nodes — accepted
            for API parity with :class:`ContinuousConvModel`; every layer here
            is per-node (the encoder MLP has ``norm=None``, gnn.py:62, and
            LayerNorm normalises within each node), so padding cannot leak
            into valid nodes' statistics and the mask is not needed.
        :return: (B, N, output_dim) predicted accelerations.
        """
        x = select_input_features(x, self.input_dim)
        if self.node_encoder_dims:
            x = MLP(
                tuple(self.node_encoder_dims) + (self.gnn_dim,),
                dropout=self.encoder_dropout,
                norm=None,  # gnn.py:62 passes norm=None
            )(x, train=train)
        encoder_output = x

        # explicit names keep the param tree identical with and without
        # remat (nn.remat would otherwise auto-name CheckpointEdgeConv_i,
        # breaking checkpoint interchange between the two modes)
        conv_cls = nn.remat(EdgeConv) if self.remat else EdgeConv
        for i in range(self.message_passing_steps):
            x = conv_cls(self.gnn_dim, self.aggr, self.fused_edgeconv,
                         name=f"EdgeConv_{i}")(x, nbr_idx, nbr_valid)

        x = jnp.concatenate([encoder_output, x], axis=-1)  # gnn.py:144
        x = nn.LayerNorm(epsilon=1e-5)(x)  # torch default eps
        out = OutputHead(
            self.output_hiddens, self.output_dim,
            zero_init=self.zero_init_output,
        )(x)
        if self.output_scale != 1.0:
            out = out / jnp.asarray(self.output_scale, out.dtype)
        return out

    def get_config(self):
        """Parity with ``GraphModel.get_config`` (gnn.py:116-128)."""
        return {
            "input_dim": self.input_dim,
            "output_hiddens": self.output_hiddens,
            "output_dim": self.output_dim,
            "node_encoder_dims": self.node_encoder_dims,
            "gnn_dim": self.gnn_dim,
            "encoder_dropout": self.encoder_dropout,
            "message_passing_steps": self.message_passing_steps,
            "aggr": self.aggr,
            "neighbors": self.neighbors,
            "scale_factor": self.scale_factor,
            "zero_init_output": self.zero_init_output,
            "output_scale": self.output_scale,
        }
