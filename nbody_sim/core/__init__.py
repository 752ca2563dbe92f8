from nbody_sim.core.forces import (
    pairwise_accelerations,
    potential_energy,
    kinetic_energy,
    energies,
)
from nbody_sim.core.integrators import leapfrog_step, euler_step, INTEGRATORS
from nbody_sim.core.simulate import SimulationConfig, simulate, Trajectory

__all__ = [
    "pairwise_accelerations",
    "potential_energy",
    "kinetic_energy",
    "energies",
    "leapfrog_step",
    "euler_step",
    "INTEGRATORS",
    "SimulationConfig",
    "simulate",
    "Trajectory",
]
