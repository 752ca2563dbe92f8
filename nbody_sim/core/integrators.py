"""Symplectic / explicit integrators as pure step functions.

Reference semantics: ``/root/reference/src/galaxify/simulation.py:153-187``.
Each integrator is a pure function ``step(pos, vel, acc, mass, acc_fn, dt)``
returning ``(pos', vel', acc')`` — composable under ``jax.lax.scan`` (see
``nbody_sim.core.simulate``) with no Python control flow inside jit.
"""

from __future__ import annotations


def leapfrog_step(pos, vel, acc, acc_fn, dt):
    """Kick-Drift-Kick leapfrog (reference ``simulation.py:153-170``):

        1. v(t + dt/2) = v(t) + (dt/2) a(t)
        2. x(t + dt)   = x(t) + dt v(t + dt/2)
        3. a(t + dt)   = acc_fn(x(t + dt))
        4. v(t + dt)   = v(t + dt/2) + (dt/2) a(t + dt)
    """
    v_half = vel + 0.5 * dt * acc
    pos_new = pos + dt * v_half
    acc_new = acc_fn(pos_new)
    vel_new = v_half + 0.5 * dt * acc_new
    return pos_new, vel_new, acc_new


def euler_step(pos, vel, acc, acc_fn, dt):
    """Semi-implicit forward Euler (reference ``simulation.py:173-187``):

        1. a(t)        = acc_fn(x(t))
        2. v(t + dt)   = v(t) + dt a(t)
        3. x(t + dt)   = x(t) + dt v(t + dt)   # uses the *updated* velocity,
                                               # exactly as the reference does
    """
    acc_new = acc_fn(pos)
    vel_new = vel + dt * acc_new
    pos_new = pos + dt * vel_new
    return pos_new, vel_new, acc_new


INTEGRATORS = {
    "leapfrog": leapfrog_step,
    "euler": euler_step,
}
