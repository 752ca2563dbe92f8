from nbody_sim.ics.profiles import spherical_hernquist_distribution
from nbody_sim.ics.disk import generate_disk
from nbody_sim.ics.spiral import generate_spiral
from nbody_sim.ics.compose import compose

GENERATORS = {"disk": generate_disk, "spiral": generate_spiral}

__all__ = [
    "spherical_hernquist_distribution",
    "generate_disk",
    "generate_spiral",
    "compose",
    "GENERATORS",
]
