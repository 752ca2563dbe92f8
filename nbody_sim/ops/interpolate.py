"""Trilinear interpolation over a (D, D, D, ...) filter grid — the JAX
replacement for ATen ``F.grid_sample`` 3-D bilinear (reference
``contconv.py:53-78``).

``grid_sample(align_corners=True)`` on coords normalised by ``(D-1)`` is
exactly direct trilinear interpolation at grid coordinates in [0, D-1]; we
implement the 8-corner gather + lerp explicitly. The heavy use-site
(ContConv's per-edge filter lookup) does NOT gather the (ci, co) matrices per
edge — see ``models/contconv.py`` for the collect-then-matmul formulation that
turns it into matrix products; this module provides the shared corner/weight math.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def trilinear_corners(coords: jax.Array, d: int) -> Tuple[jax.Array, jax.Array]:
    """Corner flat-indices and lerp weights for grid coords in [0, D-1].

    :param coords: (E, 3) grid-space coordinates.
    :param d: grid resolution D (static).
    :return: (idx, w) — (E, 8) int32 flat indices into a (D*D*D,) layout with
        index = (x*D + y)*D + z, and (E, 8) float weights summing to 1.
    """
    c = jnp.clip(coords, 0.0, d - 1)
    c0 = jnp.clip(jnp.floor(c), 0, d - 2) if d > 1 else jnp.zeros_like(c)
    f = c - c0  # fractional part in [0, 1]
    c0 = c0.astype(jnp.int32)

    x0, y0, z0 = c0[:, 0], c0[:, 1], c0[:, 2]
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]

    idxs, ws = [], []
    for ox in (0, 1):
        wx = fx if ox else (1.0 - fx)
        for oy in (0, 1):
            wy = fy if oy else (1.0 - fy)
            for oz in (0, 1):
                wz = fz if oz else (1.0 - fz)
                if d > 1:
                    flat = ((x0 + ox) * d + (y0 + oy)) * d + (z0 + oz)
                else:
                    flat = jnp.zeros_like(x0)
                idxs.append(flat)
                ws.append(wx * wy * wz)
    return jnp.stack(idxs, axis=1), jnp.stack(ws, axis=1)


def trilinear_interpolate(filters: jax.Array, coords: jax.Array) -> jax.Array:
    """Interpolate ``filters[x, y, z]`` at fractional coords — the direct
    (gather) equivalent of reference ``trilinear_interpolate``
    (``contconv.py:53-78``). Used for tests and small channel counts.

    :param filters: (D, D, D, ci, co) filter bank.
    :param coords: (E, 3) coords in [0, D-1].
    :return: (E, ci, co) interpolated filters.
    """
    d, _, _, ci, co = filters.shape
    flat = filters.reshape(d * d * d, ci * co)
    idx, w = trilinear_corners(coords, d)
    gathered = flat[idx]  # (E, 8, ci*co)
    out = jnp.sum(gathered * w[:, :, None], axis=1)
    return out.reshape(-1, ci, co)
