"""Experiment drivers. Each enables the persistent compilation cache
(:mod:`nbody_sim.utils.compile_cache`) when run as a script."""
