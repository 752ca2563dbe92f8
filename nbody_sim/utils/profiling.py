"""Profiler integration (SURVEY.md §5.1): the reference has only wall-clock
``time.time()`` spans; here hot sections can be captured as real XLA traces
viewable in TensorBoard/Perfetto."""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace_profile(logdir: str = "/tmp/nbody_sim_trace"):
    """Capture a ``jax.profiler`` device trace for the enclosed block:

        with trace_profile("/tmp/trace"):
            traj = simulate(...)
            jax.block_until_ready(traj.positions)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
