from nbody_sim.utils.timing import device_time
from nbody_sim.utils.profiling import trace_profile
from nbody_sim.utils.debug import checked_accelerations, assert_finite_state

__all__ = [
    "device_time",
    "trace_profile",
    "checked_accelerations",
    "assert_finite_state",
]
