#!/usr/bin/env python3
"""Driver benchmark. The PRIMARY line (printed first) is the 10k-body
direct-sum leapfrog rollout throughput. Secondary FRONTIER lines follow —
one JSON line each, same schema, each against its own reference-derived
baseline: the Barnes-Hut engine at 200k, the bh3 Verlet-list engine at 1M,
the GNN surrogate rollout at 100k, and the ContConv surrogate at 100k.
Every frontier line is best-effort (guarded): a failure there never
corrupts the primary metric.

Primary baseline: the reference (CPU, single device) measures ~2.9 ms/step
at 500 bodies (BASELINE.md). Direct summation scales O(N^2), so its derived
10k-body throughput is
    500 / 2.9e-3 / (10000/500) ~= 8.62e3 particle-steps/sec.
Frontier baselines (derivations in ``_frontier``):
  - BH @200k vs the O(N^2)-scaled CPU direct sum at 200k;
  - surrogates @100k vs the reference's measured per-step surrogate times
    at 500 bodies scaled linearly in N (their per-edge cost is O(N k)) —
    generous to the reference, which could never hold 100k bodies.

COMPARISON BASIS (what each line's vs_baseline means): every line divides
by the REFERENCE'S OWN engine for that workload — direct-vs-direct,
BH-vs-direct (the reference has no treecode; its only classical engine is
the O(N^2) direct sum), GNN-vs-its-GNN, ContConv-vs-its-ContConv.
"""

import json
import sys
import time

import jax

N_BODIES = 10_000
STEPS = 200
BASELINE_PSTEPS = 500 / 2.9e-3 / (N_BODIES / 500)  # O(N^2)-scaled CPU reference


def _emit(metric, psteps, baseline):
    print(json.dumps({
        "metric": metric,
        "value": round(psteps, 1),
        "unit": "particle-steps/sec",
        "vs_baseline": round(psteps / baseline, 2),
    }), flush=True)


def main():
    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.ics import generate_spiral
    from nbody_sim.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    key = jax.random.PRNGKey(0)
    pos, vel, mass = generate_spiral(key, N_BODIES)
    cfg = SimulationConfig(
        g_const=4.5e-6,
        softening=0.05,
        dt=1e-4,
        integrator="leapfrog",
        calc_energy=False,
        force_backend="auto",
    )

    # compile + warm
    jax.block_until_ready(simulate(pos, vel, mass, STEPS, cfg).positions)

    t0 = time.perf_counter()
    traj = simulate(pos, vel, mass, STEPS, cfg)
    jax.block_until_ready(traj.positions)
    elapsed = time.perf_counter() - t0

    psteps = N_BODIES * STEPS / elapsed
    _emit(
        f"direct-sum leapfrog rollout throughput ({N_BODIES} bodies, {STEPS} steps; vs reference direct sum, O(N^2)-scaled)",
        psteps, BASELINE_PSTEPS,
    )

    for name, fn in _frontier():
        try:
            fn()
        except Exception as e:  # frontier lines are best-effort
            print(f"frontier bench {name!r} skipped: {e}", file=sys.stderr)


def _frontier():
    import jax.numpy as jnp

    from nbody_sim.core.simulate import SimulationConfig, simulate
    from nbody_sim.ics import generate_spiral

    def timed(fn, out):
        jax.block_until_ready(out(fn()))  # warm
        t0 = time.perf_counter()
        r = fn()
        jax.block_until_ready(out(r))
        return time.perf_counter() - t0

    def bh_200k():
        n, steps = 200_000, 50
        pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)
        # bh2: two-level far field, B=128 near recipe
        cfg = SimulationConfig(g_const=4.5e-6, softening=0.05, dt=1e-4,
                               calc_energy=False, force_backend="bh2",
                               bh_block=128, bh_coarse=16, bh_rc=48,
                               bh_refresh=8)
        el = timed(lambda: simulate(pos, vel, mass, steps, cfg),
                   lambda t: t.positions)
        # CPU reference direct sum O(N^2)-scaled to 200k bodies
        _emit(f"Barnes-Hut rollout throughput ({n} bodies, {steps} steps; vs reference direct sum, O(N^2)-scaled — it has no treecode)",
              n * steps / el, 500 / 2.9e-3 / (n / 500))

    def bh3_1m():
        n, steps = 1_000_000, 50
        pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)
        # bh3 (Verlet sub-refined near pass) at the 1M recipe
        cfg = SimulationConfig(g_const=4.5e-6, softening=0.05, dt=1e-4,
                               calc_energy=False, force_backend="bh3",
                               bh_near=48, bh_block=128, bh_coarse=16,
                               bh_rc=48, bh_sub_block=32, bh_n_sub=48,
                               bh_refresh=8)
        el = timed(lambda: simulate(pos, vel, mass, steps, cfg),
                   lambda t: t.positions)
        _emit(f"Barnes-Hut bh3 rollout throughput ({n} bodies, {steps} steps; vs reference direct sum, O(N^2)-scaled — it has no treecode)",
              n * steps / el, 500 / 2.9e-3 / (n / 500))

    def gnn_100k():
        n, steps = 100_000, 20
        from nbody_sim.models import GraphModel
        from nbody_sim.train.graphs import build_graph
        from nbody_sim.train.rollout import autoregressive_rollout

        pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)
        model = GraphModel(input_dim=4, gnn_dim=64, message_passing_steps=2,
                          aggr="mean", neighbors=10, scale_factor=1e6,
                          knn_method="morton", fused_edgeconv=True)
        x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
        idx, valid = build_graph(model.graph_spec, x[..., :3])
        variables = jax.jit(model.init)(jax.random.PRNGKey(1), x, idx, valid)
        el = timed(
            lambda: autoregressive_rollout(model, variables, pos, vel, mass,
                                           steps + 1, 1e-4, graph_refresh=8),
            lambda r: r[0])
        # reference GNN surrogate: 2.84 ms/step at 500 bodies (CPU,
        # BASELINE.md), O(N k) => linear in N
        _emit(f"GNN surrogate rollout throughput ({n} bodies, {steps} steps; vs reference GNN, linear-N-scaled)",
              n * steps / el, 500 / 2.84e-3)

    def contconv_100k():
        # 40 steps: at 10, the startup graph build + segment padding
        # dominate (the rollout pays (steps//refresh + 1) extra builds
        # and one extra forward relative to `steps` counted steps)
        n, steps = 100_000, 40
        from nbody_sim.models import ContinuousConvModel
        from nbody_sim.train.graphs import build_graph
        from nbody_sim.train.rollout import autoregressive_rollout

        pos, vel, mass = generate_spiral(jax.random.PRNGKey(0), n)
        model = ContinuousConvModel(
            in_channels=4, out_channels=3, filter_resolution=(6, 4),
            radius=1.0, agg="mean", self_loops=True,
            continuous_conv_layers=2, continuous_conv_dim=128,
            encoder_hiddens=(32, 64), decoder_hiddens=(64, 32),
            scale_factor=1e6, radius_method="morton")
        x = jnp.concatenate([pos, vel, mass[:, None]], -1)[None]
        idx, valid = build_graph(model.graph_spec, x[..., :3])
        variables = jax.jit(model.init)(jax.random.PRNGKey(1), x, idx, valid)
        el = timed(
            lambda: autoregressive_rollout(model, variables, pos, vel, mass,
                                           steps + 1, 1e-4, graph_refresh=8),
            lambda r: r[0])
        # reference ContConv surrogate: 2.22 s/step at 500 bodies (CPU,
        # BASELINE.md), O(N k) => linear in N
        _emit(f"ContConv surrogate rollout throughput ({n} bodies, {steps} steps; vs reference ContConv, linear-N-scaled)",
              n * steps / el, 500 / 2.22)

    return [("bh_200k", bh_200k), ("bh3_1m", bh3_1m),
            ("gnn_100k", gnn_100k), ("contconv_100k", contconv_100k)]


if __name__ == "__main__":
    main()
