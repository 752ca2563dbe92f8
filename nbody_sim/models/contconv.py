"""Continuous-convolution surrogate — static-shape rebuild of the reference
``ContinuousConvModel`` (``/root/reference/contconv.py:10-240``), in the style
of Open3D continuous convolutions.

Math parity per layer (contconv.py:30-98): ball-to-cube tanh radial mapping,
trilinear lookup into a learnable (D, D, D, ci, co) filter grid, per-edge conv
``einsum('eio,ei->eo')`` weighted by the poly6 window ``(1 - d^2/r^2)^3`` with
radius cutoff, mean/sum aggregation over neighbors. The radius graph is
derived from positions on the fly exactly like the reference rebuilds it
inside forward (contconv.py:225) — here the data pipeline provides the padded
radius neighbor lists (``ops/radius.py``).

Collect-then-matmul formulation: a per-edge gather of the (ci, co)
interpolated filter matrix (what grid_sample does at contconv.py:73) would
stream gigabytes from device memory. Because aggregation and interpolation are
both linear, we swap the loop order:

    out_i = sum_e window_e sum_c w_{e,c} (f_e @ F_c)
          = sum_c [ sum_e window_e w_{e,c} f_e ] @ F_c
          = reshape(G_i, (D^3 ci)) @ reshape(F, (D^3 ci, co))

i.e. scatter window-and-corner-weighted features into per-node corner bins G
(8 adds per edge), then ONE dense matmul against the whole filter bank —
matrix-unit work instead of random gathers from device memory.

Reference bugs NOT replicated: the non-list ``filter_resolution`` branch
appending to undefined ``self.gnns`` (contconv.py:177,187) and
``self.neighbors = 0`` making the trainer's dataloader build k=0 kNN graphs
that forward then ignores (contconv.py:131).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import flax.linen as nn
import jax
import jax.numpy as jnp

from nbody_sim.models.common import gather_neighbors, select_input_features
from nbody_sim.models.mlp import MLP, OutputHead
from nbody_sim.ops.interpolate import trilinear_corners

DEFAULT_RADIUS_KMAX = 32  # PyG radius_graph's silent max_num_neighbors default


def ball_to_cube(r: jax.Array) -> jax.Array:
    """Radial tanh mapping of displacement vectors into the unit cube
    (contconv.py:30-33): r_unit * tanh(|r|).

    The norm uses the safe-sqrt pattern (``sqrt(max(|r|^2, tiny))``): a
    plain ``jnp.linalg.norm`` has a NaN VJP at r = 0, and self-loop edges
    ARE r = 0 — position gradients through the layer (differentiable
    rollout) would be NaN-poisoned. Forward values change by < 1e-12 only
    inside |r| < 1e-12; at exactly r = 0 the gradient is the finite
    one-sided limit instead of NaN."""
    n2 = jnp.sum(r * r, axis=-1, keepdims=True)
    norm = jnp.sqrt(jnp.maximum(n2, 1e-24))
    return r / (norm + 1e-8) * jnp.tanh(norm)


def conv_geometry(pos, nbr_idx, nbr_valid, radius, pos_src=None):
    """Shared per-step edge geometry for a stack of ContinuousConv layers.

    Positions (and therefore the neighbor-position gather, the poly6
    window and the ball->cube map) are fixed across the layers of one
    model call, so a stack computes this once instead of per layer.

    :param pos_src: optional separate gather source for neighbor positions
        (``nbr_idx`` indexes into it). Defaults to ``pos``; the
        particle-sharded forward passes the all-gathered full positions
        here while ``pos`` holds only the local shard's rows.
    :return: dict with ``mapped`` (B, N, k, 3), ``window`` / ``in_radius``
        (B, N, k), ``nbr_idx`` (B, N, k), and ``radius``.
    """
    pos_j = gather_neighbors(pos if pos_src is None else pos_src,
                             nbr_idx)  # (B, N, k, 3)
    r = pos_j - pos[:, :, None, :]  # neighbor - center (contconv.py:84)
    dist2 = jnp.sum(r * r, axis=-1)  # (B, Na, k)
    r2 = jnp.asarray(radius, dist2.dtype) ** 2
    in_radius = (dist2 < r2) & nbr_valid
    window = jnp.where(in_radius, (1.0 - dist2 / r2) ** 3, 0.0)
    return {
        "mapped": ball_to_cube(r),
        "window": window,
        "in_radius": in_radius,
        "nbr_idx": nbr_idx,
        "radius": radius,
    }


class ContinuousConv(nn.Module):
    """One continuous-convolution layer (contconv.py:10-98), as a
    collect-then-matmul einsum: per-edge trilinear corner weights gathered
    into per-node (D^3, ci) bins, then one product with the filter bank.
    It materialises (B, N, k, D^3) and (B, N, D^3, ci) intermediates; a
    fused gather-weight-matmul kernel that avoids them is a ROADMAP item."""

    in_channels: int
    out_channels: int
    filter_resolution: int = 4
    radius: float = 0.5
    agg: str = "mean"

    @nn.compact
    def __call__(self, pos, feat, nbr_idx, nbr_valid, geom=None,
                 feat_src=None):
        """:param pos: (B, N, 3) positions.
        :param feat: (B, N, ci) node features.
        :param nbr_idx/nbr_valid: (B, N, k) padded radius neighbor lists.
        :param geom: optional precomputed :func:`conv_geometry` — a model
            with several conv layers shares one (positions are fixed
            within a step, so the window/ball-map work and the row-bound
            neighbor-position gather are layer-invariant).
        :param feat_src: optional separate gather source for neighbor
            features (``nbr_idx`` indexes into it); the particle-sharded
            forward passes the all-gathered full features here (with a
            matching ``pos_src`` geom) while ``pos``/``feat`` hold only the
            local shard's rows.
        :return: (B, N, co).
        """
        d = self.filter_resolution
        filters = self.param(
            "filters",
            nn.initializers.normal(stddev=1.0),  # torch.randn, contconv.py:20-27
            (d, d, d, self.in_channels, self.out_channels),
        )

        if geom is None:
            geom = conv_geometry(pos, nbr_idx, nbr_valid, self.radius)
        else:
            assert geom["radius"] == self.radius, (
                "shared conv_geometry was built with a different radius")
        mapped, window = geom["mapped"], geom["window"]
        in_radius, nbr_idx = geom["in_radius"], geom["nbr_idx"]
        b, na, k = nbr_idx.shape

        grid_coords = (mapped + 1.0) * ((d - 1) / 2.0)  # contconv.py:90
        fsrc = feat if feat_src is None else feat_src

        feat_j = gather_neighbors(fsrc, nbr_idx)  # (B, Na, k, ci)
        cidx, cw = trilinear_corners(grid_coords.reshape(-1, 3), d)
        cidx = cidx.reshape(b, na, k, 8)
        cw = cw.reshape(b, na, k, 8)
        wf = feat_j * window[..., None]  # window pre-aggregation

        # Per-edge dense corner-weight row over the D^3 cells, then collect
        # per-node corner bins G with one einsum (a matrix product; a
        # scatter-add formulation serialises its colliding updates).
        cells = jnp.arange(d * d * d)
        oh = jnp.zeros((b, na, k, d * d * d), feat.dtype)
        for c in range(8):
            oh = oh + (cidx[..., c, None] == cells) * cw[..., c, None]
        g = jnp.einsum("bnkz,bnki->bnzi", oh, wf)  # (B, N, D^3, ci)

        # One matmul against the whole filter bank (default precision: this
        # is a learned layer, reduced-precision multiplies with fp32
        # accumulation are plenty).
        out = jnp.einsum(
            "bnzi,zio->bno",
            g,
            filters.reshape(d * d * d, self.in_channels, self.out_channels),
        )

        if self.agg == "mean":  # scatter(..., reduce=mean), contconv.py:95-97
            cnt = jnp.sum(in_radius.astype(out.dtype), axis=-1, keepdims=True)
            out = out / jnp.maximum(cnt, 1.0)
        elif self.agg != "sum":
            raise ValueError(f"unknown agg {self.agg!r}")
        return out


class ContinuousConvModel(nn.Module):
    """Reference ctor parity (contconv.py:102-134). ``filter_resolution`` may
    be an int or a per-layer sequence (the working list branch at
    contconv.py:152-173)."""

    in_channels: int = 4
    out_channels: int = 3
    filter_resolution: Union[int, Tuple[int, ...]] = (4,)
    radius: float = 0.5
    agg: str = "mean"
    self_loops: bool = True
    continuous_conv_layers: int = 1
    continuous_conv_dim: int = 64
    continuous_conv_dropout: float = 0.0
    encoder_hiddens: Optional[Tuple[int, ...]] = None
    encoder_dropout: float = 0.0
    decoder_hiddens: Optional[Tuple[int, ...]] = None
    decoder_dropout: float = 0.0
    scale_factor: float = 1.0
    radius_kmax: int = DEFAULT_RADIUS_KMAX
    zero_init_output: bool = False
    output_scale: float = 1.0  # net output divided by this — see
    # GraphModel.output_scale for why (Adam cannot reach the ~1e-9 weight
    # scale raw ~1e-7 targets need); apply() stays in physical units
    radius_method: Optional[str] = None  # None/"exact" | "morton" (large N)

    @property
    def graph_spec(self):
        """Radius graph rebuilt from positions each call (contconv.py:225);
        ``radius_kmax`` mirrors PyG radius_graph's max_num_neighbors=32."""
        spec = {
            "radius": self.radius,
            "k_max": self.radius_kmax,
            "include_self": self.self_loops,
        }
        if self.radius_method:
            spec["method"] = self.radius_method
        return ("radius", spec)

    def _resolutions(self) -> Sequence[int]:
        fr = self.filter_resolution
        if isinstance(fr, int):
            return [fr] * self.continuous_conv_layers
        assert len(fr) >= self.continuous_conv_layers
        return list(fr)

    @nn.compact
    def __call__(self, x, nbr_idx, nbr_valid, train: bool = False,
                 node_mask=None):
        """:param x: (B, N, 7) node features [pos | vel | mass].
        :param node_mask: optional (B, N) validity for padded nodes. The
            encoder's BatchNorm computes batch statistics over exactly the
            valid nodes (torch BatchNorm1d sees only real nodes because PyG
            batches are unpadded, contconv.py:135-141).
        :return: (B, N, out_channels) predicted accelerations.
        """
        x = select_input_features(x, self.in_channels)
        pos = x[..., :3]  # contconv.py:223

        if self.encoder_hiddens:
            x = MLP(
                tuple(self.encoder_hiddens) + (self.continuous_conv_dim,),
                dropout=self.encoder_dropout,
                norm="batch_norm",  # PyG MLP default kept by contconv.py:136
            )(x, train=train, mask=node_mask)
        encoder_output = x

        resolutions = self._resolutions()
        geom = conv_geometry(pos, nbr_idx, nbr_valid, self.radius)
        for i in range(self.continuous_conv_layers):
            ci = (
                self.in_channels
                if (i == 0 and not self.encoder_hiddens)
                else self.continuous_conv_dim
            )
            x = ContinuousConv(
                in_channels=ci,
                out_channels=self.continuous_conv_dim,
                filter_resolution=resolutions[i],
                radius=self.radius,
                agg=self.agg,
            )(pos, x, nbr_idx, nbr_valid, geom=geom)
            x = jnp.tanh(x)  # contconv.py:230
            if self.continuous_conv_dropout > 0:
                x = nn.Dropout(
                    self.continuous_conv_dropout, deterministic=not train
                )(x)

        x = nn.LayerNorm(epsilon=1e-5)(
            jnp.concatenate([encoder_output, x], axis=-1)
        )  # contconv.py:233
        out = OutputHead(
            self.decoder_hiddens, self.out_channels,
            zero_init=self.zero_init_output,
        )(x)
        if self.output_scale != 1.0:
            out = out / jnp.asarray(self.output_scale, out.dtype)
        return out

    def get_config(self):
        return {
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "filter_resolution": self.filter_resolution,
            "radius": self.radius,
            "agg": self.agg,
            "self_loops": self.self_loops,
            "continuous_conv_layers": self.continuous_conv_layers,
            "continuous_conv_dim": self.continuous_conv_dim,
            "continuous_conv_dropout": self.continuous_conv_dropout,
            "encoder_hiddens": self.encoder_hiddens,
            "encoder_dropout": self.encoder_dropout,
            "decoder_hiddens": self.decoder_hiddens,
            "decoder_dropout": self.decoder_dropout,
            "scale_factor": self.scale_factor,
            "radius_kmax": self.radius_kmax,
            "zero_init_output": self.zero_init_output,
            "output_scale": self.output_scale,
        }
