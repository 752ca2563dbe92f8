"""Ring all-pairs gravity over a device mesh — the multi-chip scaling path.

The particle axis is sharded across the mesh (the sequence-parallel analog
for this workload, SURVEY.md §2.9b): each device owns an i-chunk of particles
and a rotating j-chunk of force sources. Every ring step computes the partial
forces of the resident j-chunk on the local i-chunk, then rotates the j-chunk
to the next device with ``jax.lax.ppermute`` — structurally ring
attention applied to gravity. After ``n_devices`` hops every i-chunk has seen
every source exactly once; the global self-pair contributes zero exactly
once (masked via ``diag_delta`` in the dense backend, cancelled by the
zero displacement inside the force kernel).

The reference has no distributed path at all (no NCCL/MPI anywhere); its
O(N^2) broadcast caps out around 10^4 bodies on one device. This ring is how
the framework reaches 10^5+ bodies.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from nbody_sim.core.integrators import INTEGRATORS
from nbody_sim.ops.dispatch import resolve_impl
from nbody_sim.parallel.mesh import PARTICLE_AXIS

_HI = jax.lax.Precision.HIGHEST


def _block_accelerations_dense(pos_i, pos_j, mass_j, g_const, softening, diag_delta):
    """Dense-XLA rectangular force block: acceleration of targets ``pos_i``
    due to sources ``(pos_j, mass_j)``; self-pairs are excluded via
    ``diag_delta`` (= global_j_base - global_i_base; a global self-pair
    satisfies row_local - col_local == diag_delta).

    Same math as ``core.forces.pairwise_accelerations`` but shaped for a
    shard x shard block. Uses exact displacement differences (numerical
    parity with the reference); for very large shards prefer the "pallas"
    backend, which never materialises the (Ni, Nj, 3) tensor.
    """
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    diff = pos_j[None, :, :] - pos_i[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1) + jnp.asarray(softening, pos_i.dtype) ** 2
    inv = jax.lax.rsqrt(jnp.maximum(d2, 1e-30))
    w = inv * inv * inv * mass_j[None, :]
    row = jax.lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
    w = jnp.where(row - col == diag_delta, 0.0, w)
    return jnp.asarray(g_const, pos_i.dtype) * (
        jnp.matmul(w, pos_j, precision=_HI)
        - pos_i * jnp.sum(w, axis=1, keepdims=True)
    )


def _block_accelerations_pallas(pos_i, pos_j, mass_j, g_const, softening,
                                diag_delta, interpret=False):
    # diag_delta is unused: the kernel has no diagonal mask — the only
    # coincident pairs in a ring hop are global self-pairs, whose force
    # cancels to exact zero inside the kernel (ops/pairwise.py)
    del diag_delta
    from nbody_sim.ops.pairwise import pallas_partial_accelerations

    return pallas_partial_accelerations(
        pos_i, pos_j, mass_j, g_const, softening, interpret=interpret)


def _block_fn(backend: str, interpret: bool):
    """Per-hop block evaluator: "dense" (XLA), "pallas" (the kernel) or
    "auto" (:func:`nbody_sim.ops.dispatch.resolve_impl`)."""
    if backend == "auto":
        backend = "pallas" if resolve_impl() == "pallas" else "dense"
    if backend == "dense":
        return _block_accelerations_dense
    if backend == "pallas":
        return partial(_block_accelerations_pallas, interpret=interpret)
    raise ValueError(f"unknown ring backend {backend!r}")


def ring_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    mesh: Mesh,
    axis: str = PARTICLE_AXIS,
    backend: str = "auto",
    interpret: bool = False,
) -> jax.Array:
    """Direct-sum accelerations with the particle axis sharded over ``mesh``.

    :param pos: (N, 3) global array, N divisible by mesh.shape[axis]
        (pad with zero-mass slots otherwise).
    :param backend: "dense" (pure XLA), "pallas" (the force kernel per
        block) or "auto" (kernel on the GPU, XLA on the CPU).
    :param interpret: run the kernel on the CPU interpreter (tests).
    :return: (N, 3) accelerations, sharded like ``pos``.
    """
    n_dev = mesh.shape[axis]
    if pos.shape[0] % n_dev:
        raise ValueError(f"N={pos.shape[0]} not divisible by mesh axis {n_dev}")
    block_fn = _block_fn(backend, interpret)
    perm = [(d, (d + 1) % n_dev) for d in range(n_dev)]

    def local(pos_l, mass_l):
        chunk = pos_l.shape[0]
        my = jax.lax.axis_index(axis)

        def body(s, carry):
            acc, pj, mj = carry
            src = jnp.mod(my - s, n_dev)
            delta = (src - my) * chunk  # global col base - global row base
            acc = acc + block_fn(pos_l, pj, mj, g_const, softening, delta)
            # Rotate the source chunk around the ring (skip last hop's
            # result is still needed by nobody, but a uniform loop keeps the
            # collective schedule static).
            pj = jax.lax.ppermute(pj, axis, perm)
            mj = jax.lax.ppermute(mj, axis, perm)
            return acc, pj, mj

        acc0 = jnp.zeros_like(pos_l)
        acc, _, _ = jax.lax.fori_loop(0, n_dev, body, (acc0, pos_l, mass_l))
        return acc

    spec_pv = P(axis, None)
    spec_m = P(axis)
    return shard_map(
        local,
        mesh=mesh,
        in_specs=(spec_pv, spec_m),
        out_specs=spec_pv,
        check_vma=False,
    )(pos, mass)


def ring_energies(
    pos, vel, mass, g_const, softening, mesh, axis: str = PARTICLE_AXIS
) -> Tuple[jax.Array, jax.Array]:
    """(U, K) with the same semantics as ``core.forces.energies``
    (reference ``simulation.py:91-115``), computed over the ring:
    U = -G/2 * sum_{i != j} m_i m_j / (d_ij + eps), each unordered pair
    counted once after the halving."""
    n_dev = mesh.shape[axis]
    perm = [(d, (d + 1) % n_dev) for d in range(n_dev)]
    eps = jnp.float32(softening)

    def local(pos_l, vel_l, mass_l):
        chunk = pos_l.shape[0]
        my = jax.lax.axis_index(axis)

        def body(s, carry):
            u, pj, mj = carry
            src = jnp.mod(my - s, n_dev)
            delta = (src - my) * chunk  # global col base - global row base
            ni, nj = pos_l.shape[0], pj.shape[0]
            sqi = jnp.sum(pos_l * pos_l, -1)
            sqj = jnp.sum(pj * pj, -1)
            d2 = sqi[:, None] + sqj[None, :] - 2.0 * jnp.matmul(
                pos_l, pj.T, precision=_HI
            )
            dist = jnp.sqrt(jnp.maximum(d2, 0.0)) + eps
            mm = mass_l[:, None] * mj[None, :]
            row = jax.lax.broadcasted_iota(jnp.int32, (ni, nj), 0)
            col = jax.lax.broadcasted_iota(jnp.int32, (ni, nj), 1)
            pair = jnp.where(row - col == delta, 0.0, -mm / dist)
            u = u + jnp.sum(pair)
            pj = jax.lax.ppermute(pj, axis, perm)
            mj = jax.lax.ppermute(mj, axis, perm)
            return u, pj, mj

        u, _, _ = jax.lax.fori_loop(
            0, n_dev, body, (jnp.float32(0), pos_l, mass_l)
        )
        k = jnp.sum(0.5 * mass_l * jnp.sum(vel_l * vel_l, -1))
        u = 0.5 * jnp.float32(g_const) * jax.lax.psum(u, axis)
        k = jax.lax.psum(k, axis)
        return u[None], k[None]

    u, k = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )(pos, vel, mass)
    return u[0], k[0]


def ring_simulate(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    steps: int,
    g_const: float,
    softening: float,
    dt: float,
    mesh: Mesh,
    integrator: str = "leapfrog",
    backend: str = "auto",
    calc_energy: bool = False,
    axis: str = PARTICLE_AXIS,
    return_trajectory: bool = False,
    interpret: bool = False,
):
    """Multi-device leapfrog/Euler rollout: ``lax.scan`` over ring force
    evaluations; state stays sharded on the particle axis for the whole run.

    Returns (pos, vel, acc) final state, plus (u, k) energy traces of shape
    (steps,) when ``calc_energy``. With ``return_trajectory`` the first
    element is instead the full stacked (steps, N, 3) trajectory arrays,
    sharded on the particle axis (mind device memory: steps x N x 36
    bytes).
    """
    sharding = NamedSharding(mesh, P(axis, None))
    msharding = NamedSharding(mesh, P(axis))
    pos = jax.device_put(jnp.asarray(pos, jnp.float32), sharding)
    vel = jax.device_put(jnp.asarray(vel, jnp.float32), sharding)
    mass = jax.device_put(jnp.asarray(mass, jnp.float32), msharding)

    acc_fn = lambda p: ring_accelerations(
        p, mass, g_const, softening, mesh, axis=axis, backend=backend,
        interpret=interpret,
    )
    step_fn = INTEGRATORS[integrator]

    @jax.jit
    def run(pos, vel):
        acc0 = acc_fn(pos)

        def body(carry, _):
            p, v, a = carry
            p, v, a = step_fn(p, v, a, acc_fn, jnp.float32(dt))
            if calc_energy:
                u, k = ring_energies(p, v, mass, g_const, softening, mesh, axis)
            else:
                u = k = jnp.float32(0)
            out = (p, v, a, u, k) if return_trajectory else (u, k)
            return (p, v, a), out

        (p, v, a), out = jax.lax.scan(body, (pos, vel, acc0), None, length=steps)
        if return_trajectory:
            ps, vs, accs, us, ks = out
            return ps, vs, accs, us, ks
        us, ks = out
        return p, v, a, us, ks

    p, v, a, us, ks = run(pos, vel)
    if calc_energy:
        return (p, v, a), (us, ks)
    return (p, v, a), None
