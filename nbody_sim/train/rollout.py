"""Fully on-device autoregressive rollout — the flagship eval capability
(reference ``trainer.py:217-226`` step + ``trainer.py:228-344`` rollout loop).

The reference pays two host/device crossings per step (graph build + .item()
readbacks, trainer.py:275-312). Here the entire sim_steps rollout is one
``lax.scan``: the learned force replaces gravity inside the same KDK update,
neighbor lists are rebuilt from predicted positions on device each step, and
the full (steps, N, 3) trajectories come back to the host once.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Tuple

import jax
import jax.numpy as jnp

from nbody_sim.train.graphs import build_graph


@partial(jax.jit, static_argnames=("model",))
def predict_accelerations(model, variables, pos, vel, mass):
    """Single-snapshot surrogate force — the reference's ``model.predict``
    (gnn.py:205-215 / contconv.py:261-271): build the model's neighbor graph
    from positions on device, run the forward pass.

    :param pos/vel: (N, 3); :param mass: (N,).
    :return: (N, 3) predicted accelerations.
    """
    x = jnp.concatenate([pos, vel, mass[:, None]], axis=-1)[None]
    idx, valid = build_graph(model.graph_spec, x[..., :3])
    return model.apply(variables, x, idx, valid, train=False)[0]


@partial(jax.jit, static_argnames=("model", "steps", "graph_spec",
                                   "graph_refresh"))
def autoregressive_rollout(
    model,
    variables: Any,
    pos0: jax.Array,
    vel0: jax.Array,
    mass: jax.Array,
    steps: int,
    dt: float,
    graph_spec=None,
    graph_refresh: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Roll a single scene forward with the surrogate force model.

    Semantics of ``Trainer.step`` (trainer.py:217-226): half-kick with the
    previous acceleration, drift, predict a(t+dt) from the drifted positions
    and half-kicked velocities, half-kick again. The initial acceleration is
    predicted from the ground-truth step-0 state (trainer.py:238-241).

    NOTE a deliberate divergence: the reference's rollout builds its kNN
    graphs with ``transform_to_graph``'s default k=50 (gnn.py:11,205) even
    when the model was trained with k=10 — we default to the model's own
    ``graph_spec`` (override via ``graph_spec`` for the reference quirk).

    :param graph_spec: hashable ((kind, tuple(kwargs.items()))) override;
        None uses ``model.graph_spec``.
    :param graph_refresh: rebuild the neighbor graph every this many steps
        and reuse the cached indices in between — the Verlet-neighbor-list
        trick from classical MD, amortising the search cost at large N.
        kNN(10) turnover per dt=1e-4 leapfrog step is tiny, so small values
        (4-10) are physically safe; the default 1 keeps exact per-step
        rebuild parity with the reference (contconv.py:225, gnn.py:13).
    :return: (pos, vel, acc) each (steps, N, 3); row 0 is the initial state
        with the predicted initial acceleration.
    """
    spec = model.graph_spec if graph_spec is None else (
        (graph_spec[0], dict(graph_spec[1]))
    )
    mass_col = mass[:, None]

    def forward(pos, vel, idx, valid):
        x = jnp.concatenate([pos, vel, mass_col], axis=-1)[None]
        return model.apply(variables, x, idx, valid, train=False)[0]

    def predict(pos, vel):
        idx, valid = build_graph(spec, pos[None])
        return forward(pos, vel, idx, valid)

    acc0 = predict(pos0, vel0)

    def step_with(carry, idx, valid, rebuild):
        pos, vel, acc = carry
        v_half = vel + 0.5 * dt * acc
        pos_n = pos + dt * v_half
        if rebuild:
            acc_n = predict(pos_n, v_half)
        else:
            acc_n = forward(pos_n, v_half, idx, valid)
        vel_n = v_half + 0.5 * dt * acc_n
        return (pos_n, vel_n, acc_n)

    if graph_refresh <= 1:
        def body(carry, _):
            carry = step_with(carry, None, None, True)
            return carry, carry

        _, (ps, vs, accs) = jax.lax.scan(
            body, (pos0, vel0, acc0), None, length=steps - 1
        )
    else:
        r = graph_refresh
        n_seg = -(-(steps - 1) // r)

        def segment(carry, _):
            # one graph build per segment, r (possibly padded) steps reuse it
            idx, valid = build_graph(spec, carry[0][None])

            def inner(c, _):
                c = step_with(c, idx, valid, False)
                return c, c

            carry, outs = jax.lax.scan(inner, carry, None, length=r)
            return carry, outs

        _, segs = jax.lax.scan(
            segment, (pos0, vel0, acc0), None, length=n_seg
        )
        ps, vs, accs = (
            s.reshape((n_seg * r,) + s.shape[2:])[: steps - 1] for s in segs
        )

    ps = jnp.concatenate([pos0[None], ps], axis=0)
    vs = jnp.concatenate([vel0[None], vs], axis=0)
    accs = jnp.concatenate([acc0[None], accs], axis=0)
    return ps, vs, accs
