"""Particle-sharded Barnes-Hut-lite forces — the approximate classical
engine (``ops/treeforce.py``) across the device mesh.

Decomposition: the dominant cost is the exact near pass, O(N·M·B), and it
splits cleanly by *receiver block* — each device computes the near+far
field for its contiguous range of Morton blocks via
:func:`ops.treeforce.bh_sorted_range_acc`. Inputs are small (16 B/particle),
so each device all_gathers the particle state over the interconnect and
keeps the block moments replicated (they cost O(nb) ~ KBs); what is sharded is the O(N·M·B)
compute and the O(N·nb/D) far pass. The sorted per-range results are
all_gathered (12 B/particle) and unsorted locally.

Memory stays O(N) per device (same as ``parallel.ring``, whose all-pairs
exchange is also state-replicated per step) — the scaling axis here is
compute, which is what caps step time at 10^5-10^6 bodies.

Like the single-device backend, the partition may be stale
(``graph_refresh`` economics); it is built replicated from the gathered
positions when not supplied.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nbody_sim.ops.dispatch import resolve_impl
from nbody_sim.ops.treeforce import (
    BH2Partition,
    BHPartition,
    _gather_sorted,
    _unsort_acc,
    bh2_sorted_range_acc,
    bh_sorted_range_acc,
    build_bh2_partition,
    build_bh_partition,
)


def _force_local(pall, mall, part, axis, n, nb, block, nbp, n_dev, shard,
                 g_const, softening, i_chunk, near_impl):
    """Per-device BH force: compute this device's receiver-block range on
    the (gathered, replicated) state and return the local rows in original
    order. Shared by the one-shot force wrapper and the scanned rollout."""
    spos, sm = _gather_sorted(pall, mall, part)
    # pad sorted arrays/near sets so every device owns exactly nbp
    # receiver blocks; pad blocks are massless and their rows are
    # dropped after the gather
    bpad = nbp * n_dev - nb
    spos_p = jnp.pad(spos, ((0, bpad * block), (0, 0)))
    sm_p = jnp.pad(sm, (0, bpad * block))
    near_p = jnp.pad(part.near, ((0, bpad), (0, 0)))

    me = jax.lax.axis_index(axis)
    acc_rng = bh_sorted_range_acc(
        spos_p, sm_p, near_p, g_const, softening,
        (me * nbp).astype(jnp.int32), nbp,
        i_chunk=i_chunk, near_impl=near_impl,
    )  # (nbp*B, 3) my receiver rows, sorted order

    acc_sorted = jax.lax.all_gather(acc_rng, axis, tiled=True)
    # the partition's slots: whole superblocks for bh2/bh3, so possibly
    # more than the nb blocks N alone implies
    n_slots = part.sorted_gid.shape[0]
    acc = _unsort_acc(acc_sorted[:n_slots], part.sorted_gid, n)
    return jax.lax.dynamic_slice_in_dim(acc, me * shard, shard)


@lru_cache(maxsize=64)
def _sharded_fn(mesh, axis, n, nb, block, n_near, i_chunk, near_impl,
                g_const, softening, with_partition):
    """Build-and-cache the jitted shard_map program — the closure must NOT
    be rebuilt per call or every force evaluation retraces and recompiles
    (measured ~1.5 s/call on the 8-CPU mesh vs ms of actual compute)."""
    n_dev = mesh.shape[axis]
    nbp = -(-nb // n_dev)  # receiver blocks per device
    shard = n // n_dev

    def fwd(pos_l, mass_l, part):
        pall = jax.lax.all_gather(pos_l, axis, tiled=True)
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)
        if part is None:
            part = build_bh_partition(pall, mall, n_near=n_near, block=block)
        return _force_local(
            pall, mall, part, axis, n, nb, block, nbp, n_dev, shard,
            g_const, softening, i_chunk, near_impl)

    spec = P(axis)
    if not with_partition:
        return jax.jit(jax.shard_map(
            lambda p, m_: fwd(p, m_, None), mesh=mesh,
            in_specs=(spec, spec), out_specs=spec,
            check_vma=False,  # partition/moments run replicated inside
        ))
    part_spec = BHPartition(P(), P(), P())  # replicated
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, part_spec), out_specs=spec,
        check_vma=False,
    ))


def sharded_bh_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    mesh: Mesh,
    axis: str = "particles",
    partition: Optional[BHPartition] = None,
    n_near: int = 16,
    block: int = 256,
    i_chunk: int = 64,
    near_impl: str = "auto",
) -> jax.Array:
    """(N, 3) BH accelerations with receiver blocks sharded over ``axis``.

    Matches :func:`ops.treeforce.bh_accelerations` exactly (same partition,
    same per-block arithmetic — a CPU-mesh test asserts equality); the
    particle count must be divisible by the mesh axis size. The underlying
    jitted program is cached per (mesh, shapes, knobs), so repeated calls
    (e.g. one per rollout step) pay tracing/compilation once.
    """
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)

    if partition is not None:
        nb = partition.n_blocks
        block = partition.sorted_gid.shape[0] // nb
    else:
        nb = -(-n // block)

    fn = _sharded_fn(mesh, axis, n, nb, block, n_near, i_chunk, near_impl,
                     float(g_const), float(softening), partition is not None)
    sharding = NamedSharding(mesh, P(axis))
    pos = jax.device_put(pos, sharding)
    mass = jax.device_put(mass, sharding)
    if partition is None:
        return fn(pos, mass)
    return fn(pos, mass, partition)


def _force2_local(pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp,
                  n_dev, shard, g_const, softening, i_chunk, near_impl):
    """Per-device two-level BH force: this device's range of ``nbcp``
    coarse groups (= nbcp*coarse fine receiver blocks) of
    :func:`ops.treeforce.bh2_sorted_range_acc` on the replicated state.
    Padding is by whole COARSE groups so every range stays group-aligned
    (the bh2 range API requires blk0/nbl multiples of the coarse factor);
    padded groups are massless and their rows are dropped after the
    gather, exactly like the one-level path."""
    spos, sm = _gather_sorted(pall, mall, part.base)
    cpad = nbcp * n_dev - nbc
    bpad = cpad * coarse
    spos_p = jnp.pad(spos, ((0, bpad * block), (0, 0)))
    sm_p = jnp.pad(sm, (0, bpad * block))
    near_p = jnp.pad(part.near, ((0, bpad), (0, 0)))
    refined_p = jnp.pad(part.refined, ((0, cpad), (0, 0)))

    me = jax.lax.axis_index(axis)
    nbl = nbcp * coarse
    acc_rng = bh2_sorted_range_acc(
        spos_p, sm_p, near_p, refined_p, g_const, softening,
        (me * nbl).astype(jnp.int32), nbl,
        i_chunk=i_chunk, near_impl=near_impl,
    )  # (nbl*B, 3) my receiver rows, sorted order

    acc_sorted = jax.lax.all_gather(acc_rng, axis, tiled=True)
    # the partition's slots: whole superblocks for bh2/bh3, so possibly
    # more than the nb blocks N alone implies
    n_slots = part.sorted_gid.shape[0]
    acc = _unsort_acc(acc_sorted[:n_slots], part.sorted_gid, n)
    return jax.lax.dynamic_slice_in_dim(acc, me * shard, shard)


@lru_cache(maxsize=64)
def _sharded2_fn(mesh, axis, n, nb, nbc, block, coarse, rc, n_near, i_chunk,
                 near_impl, g_const, softening, with_partition):
    n_dev = mesh.shape[axis]
    nbcp = -(-nbc // n_dev)  # coarse groups per device
    shard = n // n_dev

    def fwd(pos_l, mass_l, part):
        pall = jax.lax.all_gather(pos_l, axis, tiled=True)
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)
        if part is None:
            part = build_bh2_partition(pall, mall, n_near=n_near,
                                       block=block, coarse=coarse, rc=rc)
        return _force2_local(
            pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp, n_dev,
            shard, g_const, softening, i_chunk, near_impl)

    spec = P(axis)
    if not with_partition:
        return jax.jit(jax.shard_map(
            lambda p, m_: fwd(p, m_, None), mesh=mesh,
            in_specs=(spec, spec), out_specs=spec,
            check_vma=False,  # partition/moments run replicated inside
        ))
    part_spec = BH2Partition(P(), P(), P(), P())  # replicated
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, part_spec), out_specs=spec,
        check_vma=False,
    ))


def sharded_bh2_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    mesh: Mesh,
    axis: str = "particles",
    partition: Optional[BH2Partition] = None,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    i_chunk: int = 64,
    near_impl: str = "auto",
) -> jax.Array:
    """(N, 3) two-level BH accelerations with receiver COARSE groups
    sharded over ``axis`` — the bh2 twin of
    :func:`sharded_bh_accelerations` (matches
    :func:`ops.treeforce.bh2_accelerations`; a CPU-mesh test asserts
    equality when the group count divides the axis)."""
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)

    if partition is not None:
        nb = partition.n_blocks
        block = partition.sorted_gid.shape[0] // nb
        nbc = partition.refined.shape[0]
        coarse = nb // nbc
        # rc/n_near are only used when fwd BUILDS a partition — with a
        # prebuilt one they would be dead except as lru_cache keys, so
        # derive them from the partition itself: differing caller values
        # must not compile duplicate identical programs
        rc = partition.refined.shape[1]
        n_near = partition.near.shape[1]
    else:
        nb = -(-n // block)
        nbc = -(-nb // coarse)

    fn = _sharded2_fn(mesh, axis, n, nb, nbc, block, coarse, rc, n_near,
                      i_chunk, near_impl, float(g_const), float(softening),
                      partition is not None)
    sharding = NamedSharding(mesh, P(axis))
    pos = jax.device_put(pos, sharding)
    mass = jax.device_put(mass, sharding)
    if partition is None:
        return fn(pos, mass)
    return fn(pos, mass, partition)


@lru_cache(maxsize=32)
def _bh_simulate_fn(mesh, axis, n, steps, block, n_near, refresh, i_chunk,
                    near_impl, g_const, softening, dt):
    n_dev = mesh.shape[axis]
    nb = -(-n // block)
    nbp = -(-nb // n_dev)
    shard = n // n_dev
    from nbody_sim.core.integrators import leapfrog_step

    def fwd(pos_l, vel_l, mass_l):
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)

        def build(p_l):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return build_bh_partition(pall, mall, n_near=n_near, block=block)

        def force(p_l, part):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return _force_local(
                pall, mall, part, axis, n, nb, block, nbp, n_dev, shard,
                g_const, softening, i_chunk, near_impl)

        def body(carry, i):
            p_l, v_l, a_l, part = carry
            # i > 0: part0 was built from these exact positions already
            part = jax.lax.cond((i % refresh == 0) & (i > 0), build,
                                lambda _: part, p_l)
            p_l, v_l, a_l = leapfrog_step(
                p_l, v_l, a_l, lambda q: force(q, part), jnp.float32(dt))
            return (p_l, v_l, a_l, part), None

        part0 = build(pos_l)
        a0 = force(pos_l, part0)
        (p_l, v_l, a_l, _), _ = jax.lax.scan(
            body, (pos_l, vel_l, a0, part0), jnp.arange(steps))
        return p_l, v_l, a_l

    spec = P(axis)
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,  # partition/moments run replicated inside
    ))


@lru_cache(maxsize=32)
def _bh2_simulate_fn(mesh, axis, n, steps, block, coarse, rc, n_near,
                     refresh, i_chunk, near_impl, g_const, softening, dt):
    n_dev = mesh.shape[axis]
    nb = -(-n // block)
    nbc = -(-nb // coarse)
    nbcp = -(-nbc // n_dev)
    shard = n // n_dev
    from nbody_sim.core.integrators import leapfrog_step

    def fwd(pos_l, vel_l, mass_l):
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)

        def build(p_l):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return build_bh2_partition(pall, mall, n_near=n_near,
                                       block=block, coarse=coarse, rc=rc)

        def force(p_l, part):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return _force2_local(
                pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp,
                n_dev, shard, g_const, softening, i_chunk, near_impl)

        def body(carry, i):
            p_l, v_l, a_l, part = carry
            # i > 0: part0 was built from these exact positions already
            part = jax.lax.cond((i % refresh == 0) & (i > 0), build,
                                lambda _: part, p_l)
            p_l, v_l, a_l = leapfrog_step(
                p_l, v_l, a_l, lambda q: force(q, part), jnp.float32(dt))
            return (p_l, v_l, a_l, part), None

        part0 = build(pos_l)
        a0 = force(pos_l, part0)
        (p_l, v_l, a_l, _), _ = jax.lax.scan(
            body, (pos_l, vel_l, a0, part0), jnp.arange(steps))
        return p_l, v_l, a_l

    spec = P(axis)
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,  # partition/moments run replicated inside
    ))


def bh2_simulate(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    steps: int,
    g_const: float,
    softening: float,
    dt: float,
    mesh: Mesh,
    axis: str = "particles",
    n_near: int = 32,
    block: int = 128,
    coarse: int = 16,
    rc: int = 32,
    refresh: int = 8,
    i_chunk: int = 64,
    near_impl: str = "auto",
):
    """Multi-device two-level BH leapfrog rollout — the bh2 twin of
    :func:`bh_simulate` (coarse-group-sharded
    :func:`ops.treeforce.bh2_sorted_range_acc` inside one scanned
    ``shard_map`` program, partition refreshed every ``refresh`` steps).
    Default knobs are the 1M-body bench recipe (B=128, M=32, C=16,
    rc=48→32 small-N clamp-safe default).

    :return: final ``(pos, vel, acc)``, each (N, 3) sharded over ``axis``.
    """
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)
    fn = _bh2_simulate_fn(mesh, axis, n, steps, block, coarse, rc, n_near,
                          refresh, i_chunk, near_impl, float(g_const),
                          float(softening), float(dt))
    sharding = NamedSharding(mesh, P(axis))
    return fn(jax.device_put(pos, sharding), jax.device_put(vel, sharding),
              jax.device_put(mass, sharding))


def bh_simulate(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    steps: int,
    g_const: float,
    softening: float,
    dt: float,
    mesh: Mesh,
    axis: str = "particles",
    n_near: int = 32,
    block: int = 256,
    refresh: int = 8,
    i_chunk: int = 64,
    near_impl: str = "auto",
):
    """Multi-device Barnes-Hut leapfrog rollout — the approximate-engine
    twin of :func:`parallel.ring.ring_simulate`: the whole ``steps`` scan
    runs inside one jitted ``shard_map`` program, the Morton partition is
    rebuilt from fresh positions every ``refresh`` steps (carried through
    the scan otherwise), and every step's force uses this device's
    receiver-block range of :func:`ops.treeforce.bh_sorted_range_acc`.

    :return: final ``(pos, vel, acc)``, each (N, 3) sharded over ``axis``.
    """
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)
    fn = _bh_simulate_fn(mesh, axis, n, steps, block, n_near, refresh,
                         i_chunk, near_impl, float(g_const),
                         float(softening), float(dt))
    sharding = NamedSharding(mesh, P(axis))
    return fn(jax.device_put(pos, sharding), jax.device_put(vel, sharding),
              jax.device_put(mass, sharding))


def _force3_local(pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp,
                  n_dev, shard, g_const, softening, i_chunk, near_impl):
    """Per-device sub-refined two-level BH force — the bh3 twin of
    :func:`_force2_local` (same coarse-group-aligned receiver ranges; the
    near pass runs the sub-block exact/multipole split of
    :func:`ops.treeforce.bh3_sorted_range_acc`)."""
    from nbody_sim.ops.treeforce import bh3_sorted_range_acc

    spos, sm = _gather_sorted(pall, mall, part.base)
    cpad = nbcp * n_dev - nbc
    bpad = cpad * coarse
    spos_p = jnp.pad(spos, ((0, bpad * block), (0, 0)))
    sm_p = jnp.pad(sm, (0, bpad * block))
    near_p = jnp.pad(part.near, ((0, bpad), (0, 0)))
    refined_p = jnp.pad(part.refined, ((0, cpad), (0, 0)))
    sel_p = jnp.pad(part.sub_near, ((0, bpad), (0, 0)))
    far_p = jnp.pad(part.sub_far, ((0, bpad), (0, 0)))

    me = jax.lax.axis_index(axis)
    nbl = nbcp * coarse
    acc_rng = bh3_sorted_range_acc(
        spos_p, sm_p, near_p, refined_p, sel_p, far_p, g_const, softening,
        (me * nbl).astype(jnp.int32), nbl,
        i_chunk=i_chunk, near_impl=near_impl,
    )  # (nbl*B, 3) my receiver rows, sorted order

    acc_sorted = jax.lax.all_gather(acc_rng, axis, tiled=True)
    # the partition's slots: whole superblocks for bh2/bh3, so possibly
    # more than the nb blocks N alone implies
    n_slots = part.sorted_gid.shape[0]
    acc = _unsort_acc(acc_sorted[:n_slots], part.sorted_gid, n)
    return jax.lax.dynamic_slice_in_dim(acc, me * shard, shard)


@lru_cache(maxsize=64)
def _sharded3_fn(mesh, axis, n, nb, nbc, block, coarse, rc, n_near,
                 sub_block, n_sub, i_chunk, near_impl, g_const, softening,
                 with_partition):
    from nbody_sim.ops.treeforce import BH3Partition, build_bh3_partition

    n_dev = mesh.shape[axis]
    nbcp = -(-nbc // n_dev)  # coarse groups per device
    shard = n // n_dev

    def fwd(pos_l, mass_l, part):
        pall = jax.lax.all_gather(pos_l, axis, tiled=True)
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)
        if part is None:
            part = build_bh3_partition(
                pall, mall, n_near=n_near, block=block, coarse=coarse,
                rc=rc, sub_block=sub_block, n_sub=n_sub)
        return _force3_local(
            pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp, n_dev,
            shard, g_const, softening, i_chunk, near_impl)

    spec = P(axis)
    if not with_partition:
        return jax.jit(jax.shard_map(
            lambda p, m_: fwd(p, m_, None), mesh=mesh,
            in_specs=(spec, spec), out_specs=spec,
            check_vma=False,  # partition/moments run replicated inside
        ))
    part_spec = BH3Partition(P(), P(), P(), P(), P(), P())  # replicated
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, part_spec), out_specs=spec,
        check_vma=False,
    ))


def sharded_bh3_accelerations(
    pos: jax.Array,
    mass: jax.Array,
    g_const: float,
    softening: float,
    mesh: Mesh,
    axis: str = "particles",
    partition=None,
    n_near: int = 16,
    block: int = 256,
    coarse: int = 16,
    rc: int = 32,
    sub_block: int = 32,
    n_sub: int = 24,
    i_chunk: int = 64,
    near_impl: str = "auto",
) -> jax.Array:
    """(N, 3) sub-refined two-level BH accelerations with receiver coarse
    groups sharded over ``axis`` — the bh3 twin of
    :func:`sharded_bh2_accelerations` (matches
    :func:`ops.treeforce.bh3_accelerations`; a CPU-mesh test asserts
    equality when the group count divides the axis)."""
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)

    if partition is not None:
        nb = partition.n_blocks
        block = partition.sorted_gid.shape[0] // nb
        nbc = partition.refined.shape[0]
        coarse = nb // nbc
        # all selection knobs derive from the partition (differing dead
        # caller values must not compile duplicate programs)
        rc = partition.refined.shape[1]
        n_near = partition.near.shape[1]
        n_sub = partition.sub_near.shape[1]
        s = (n_sub + partition.sub_far.shape[1]) // n_near
        sub_block = block // s
    else:
        nb = -(-n // block)
        nbc = -(-nb // coarse)

    fn = _sharded3_fn(mesh, axis, n, nb, nbc, block, coarse, rc, n_near,
                      sub_block, n_sub, i_chunk, near_impl, float(g_const),
                      float(softening), partition is not None)
    sharding = NamedSharding(mesh, P(axis))
    pos = jax.device_put(pos, sharding)
    mass = jax.device_put(mass, sharding)
    if partition is None:
        return fn(pos, mass)
    return fn(pos, mass, partition)


@lru_cache(maxsize=32)
def _bh3_simulate_fn(mesh, axis, n, steps, block, coarse, rc, n_near,
                     sub_block, n_sub, refresh, i_chunk, near_impl, g_const,
                     softening, dt):
    from nbody_sim.ops.treeforce import build_bh3_partition

    n_dev = mesh.shape[axis]
    nb = -(-n // block)
    nbc = -(-nb // coarse)
    nbcp = -(-nbc // n_dev)
    shard = n // n_dev
    from nbody_sim.core.integrators import leapfrog_step

    def fwd(pos_l, vel_l, mass_l):
        mall = jax.lax.all_gather(mass_l, axis, tiled=True)

        def build(p_l):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return build_bh3_partition(
                pall, mall, n_near=n_near, block=block, coarse=coarse,
                rc=rc, sub_block=sub_block, n_sub=n_sub)

        def force(p_l, part):
            pall = jax.lax.all_gather(p_l, axis, tiled=True)
            return _force3_local(
                pall, mall, part, axis, n, nb, nbc, block, coarse, nbcp,
                n_dev, shard, g_const, softening, i_chunk, near_impl)

        def body(carry, i):
            p_l, v_l, a_l, part = carry
            # i > 0: part0 was built from these exact positions already
            part = jax.lax.cond((i % refresh == 0) & (i > 0), build,
                                lambda _: part, p_l)
            p_l, v_l, a_l = leapfrog_step(
                p_l, v_l, a_l, lambda q: force(q, part), jnp.float32(dt))
            return (p_l, v_l, a_l, part), None

        part0 = build(pos_l)
        a0 = force(pos_l, part0)
        (p_l, v_l, a_l, _), _ = jax.lax.scan(
            body, (pos_l, vel_l, a0, part0), jnp.arange(steps))
        return p_l, v_l, a_l

    spec = P(axis)
    return jax.jit(jax.shard_map(
        fwd, mesh=mesh, in_specs=(spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,  # partition/moments run replicated inside
    ))


def bh3_simulate(
    pos: jax.Array,
    vel: jax.Array,
    mass: jax.Array,
    steps: int,
    g_const: float,
    softening: float,
    dt: float,
    mesh: Mesh,
    axis: str = "particles",
    n_near: int = 32,
    block: int = 128,
    coarse: int = 16,
    rc: int = 32,
    sub_block: int = 32,
    n_sub: int = 24,
    refresh: int = 8,
    i_chunk: int = 64,
    near_impl: str = "auto",
):
    """Multi-device sub-refined two-level BH leapfrog rollout — the bh3
    twin of :func:`bh2_simulate` (the Verlet-list near pass inside one
    scanned ``shard_map`` program, partition refreshed every ``refresh``
    steps).

    :return: final ``(pos, vel, acc)``, each (N, 3) sharded over ``axis``.
    """
    n = pos.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} not divisible by mesh axis {axis}={n_dev}")
    near_impl = resolve_impl(near_impl)
    fn = _bh3_simulate_fn(mesh, axis, n, steps, block, coarse, rc, n_near,
                          sub_block, n_sub, refresh, i_chunk, near_impl,
                          float(g_const), float(softening), float(dt))
    sharding = NamedSharding(mesh, P(axis))
    return fn(jax.device_put(pos, sharding), jax.device_put(vel, sharding),
              jax.device_put(mass, sharding))
