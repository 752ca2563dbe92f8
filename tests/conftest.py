"""Test harness: by default everything runs on a virtual 8-device CPU mesh,
so sharding (ring all-pairs, sharded tree engines, data-parallel training)
is testable without accelerators (SURVEY.md §4). Kernels run in interpret
mode on the CPU.

Tests marked ``gpu`` need the card: run them there, in one process, with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``. They decide
inside a fixture whether a GPU exists and skip otherwise.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def mesh8():
    from nbody_sim.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8
    return make_mesh(8)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided at test time, never at
    import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX found "
                    f"{jax.default_backend()!r}")
