"""The one place that decides, per platform, whether a hand-written kernel
or plain XLA evaluates a force.

Every ``near_impl`` / ``force_backend="auto"`` / ring-backend default in the
package resolves through :func:`resolve_impl`:

- on ``gpu`` the Pallas kernels (Triton route) run;
- on ``cpu`` XLA runs (the kernels' interpreter is a test tool, reached only
  by an explicit ``interpret=True`` argument);
- any other platform raises — there is no silent fallback.
"""

from __future__ import annotations

import jax

IMPLS = ("pallas", "xla")


def resolve_impl(impl: str = "auto") -> str:
    """``"auto"`` -> ``"pallas"`` on the GPU, ``"xla"`` on the CPU; an
    explicit ``"pallas"`` / ``"xla"`` passes through unchanged."""
    if impl in IMPLS:
        return impl
    if impl != "auto":
        raise ValueError(f"unknown implementation {impl!r}; "
                         f"expected 'auto' or one of {IMPLS}")
    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(
        f"no force implementation for platform {platform!r} "
        "(supported: gpu, cpu)")
