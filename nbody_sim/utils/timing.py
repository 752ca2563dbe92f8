"""Honest device timing.

The reference wraps hot sections in ``time.time()`` pairs
(``simulation.py:127-129``, ``gnn.py:196-198``, ``trainer.py:238-241``) —
valid on synchronous CPU torch. Under JAX's async dispatch a call returns
before the device finishes, so a timer must end with
``jax.block_until_ready`` on the result.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax


def device_time(fn: Callable[[], object]) -> Tuple[object, float]:
    """Run ``fn`` and return (result, seconds), the clock stopped only once
    every array of the result is ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0
