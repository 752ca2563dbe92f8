"""Timing/debug utilities and IC composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_sim.ics import compose, generate_disk
from nbody_sim.utils.debug import assert_finite_state, checked_accelerations
from nbody_sim.utils.timing import device_time


def test_device_time_returns_result_and_positive_time():
    x = jnp.ones((256, 256))
    out, secs = device_time(lambda: x @ x)
    assert out.shape == (256, 256)
    assert secs > 0


def test_device_time_returns_every_leaf_ready():
    out, secs = device_time(lambda: {"a": jnp.arange(5) * 2,
                                     "b": (jnp.ones(3),)})
    assert int(out["a"].sum()) == 20 and out["b"][0].shape == (3,)
    assert secs >= 0


def test_checked_accelerations_flags_nan():
    ok_fn = checked_accelerations(lambda p: p * 2.0)
    err, acc = ok_fn(jnp.ones((4, 3)))
    err.throw()  # no error
    np.testing.assert_allclose(np.asarray(acc), 2.0)

    bad_fn = checked_accelerations(lambda p: p / jnp.zeros_like(p))
    err, _ = bad_fn(jnp.ones((4, 3)))
    with pytest.raises(Exception):
        err.throw()


def test_assert_finite_state():
    assert_finite_state(jnp.ones((2, 3)), jnp.zeros((2, 3)))
    with pytest.raises(FloatingPointError):
        assert_finite_state(jnp.array([[jnp.inf, 0, 0]]), jnp.zeros((1, 3)))


def test_compose_two_galaxies():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    a = generate_disk(k1, 30, offset=(-5.0, 0.0, 0.0), initial_vel=(0.01, 0.0, 0.0))
    b = generate_disk(k2, 20, offset=(5.0, 0.0, 0.0), initial_vel=(-0.01, 0.0, 0.0))
    pos, vel, mass = compose(a, b)
    assert pos.shape == (50, 3) and vel.shape == (50, 3) and mass.shape == (50,)
    # each half keeps its bulk offset/velocity
    assert float(pos[:30, 0].mean()) < 0 < float(pos[30:, 0].mean())
    assert float(vel[:30, 0].mean()) > 0 > float(vel[30:, 0].mean())
    np.testing.assert_allclose(np.asarray(mass[:30]), np.asarray(a[2]))
