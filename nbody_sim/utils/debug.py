"""Numerical guards (SURVEY.md §5.2): the JAX stand-in for the sanitizers the
reference lacks. ``jax.experimental.checkify`` turns silent NaN/Inf
propagation into hard errors; Pallas kernels additionally support
``interpret=True`` for step-through debugging (``ops/pairwise.py``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked_accelerations(acc_fn):
    """Wrap a ``pos -> acc`` closure with a finite-output check. Returns a
    function whose first return value is a checkify error (raise with
    ``err.throw()``)."""

    def wrapped(pos):
        def inner(p):
            acc = acc_fn(p)
            checkify.check(
                jnp.isfinite(acc).all(), "non-finite acceleration detected"
            )
            return acc

        return checkify.checkify(inner)(pos)

    return wrapped


def throw_if_nonfinite(tree, what: str = "state") -> None:
    """checkify-based NaN/Inf guard over a whole pytree: raises
    ``checkify.JaxRuntimeError`` when any leaf carries a non-finite value.
    This is what the ``--check`` CLI flags run on produced trajectories /
    trained parameters (SURVEY.md §5.2)."""

    def inner(t):
        leaves = [l for l in jax.tree_util.tree_leaves(t) if l is not None]
        ok = jnp.array(True)
        for leaf in leaves:
            if jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating):
                ok = ok & jnp.isfinite(leaf).all()
        checkify.check(ok, f"non-finite values detected in {what}")
        return 0

    err, _ = jax.jit(checkify.checkify(inner))(tree)
    err.throw()


def assert_finite_state(pos, vel, acc=None) -> None:
    """Host-side guard: raise if any state array went non-finite."""
    for name, arr in (("pos", pos), ("vel", vel), ("acc", acc)):
        if arr is None:
            continue
        if not bool(jnp.isfinite(arr).all()):
            raise FloatingPointError(f"non-finite values in {name}")
