"""nbody_sim — a JAX/XLA/Pallas N-body deep-simulation framework.

A ground-up rebuild of the capabilities of ``bikuta6/nbody-deep-sim``:

- ``core``      — direct-sum gravitational physics engine + integrators
                  (reference: ``src/galaxify/simulation.py``)
- ``ics``       — galaxy initial-condition generators ("galaxify")
                  (reference: ``src/galaxify/galaxies.py``)
- ``ops``       — kernels and primitives: tiled all-pairs and multipole
                  kernels (Pallas through Triton), the platform switch,
                  fixed-degree kNN / padded radius neighbor lists,
                  trilinear filter interpolation (replacing torch-cluster /
                  torch-scatter / ATen grid_sample)
- ``parallel``  — device-mesh sharding: ring all-pairs forces over the
                  particle axis via shard_map + ppermute
- ``models``    — learned force surrogates: EdgeConv GNN (reference:
                  ``gnn.py``) and continuous convolution (``contconv.py``)
- ``data``      — trajectory dataset generation + bucketed snapshot batching
                  (reference: ``src/s01-dataset-generation.py``, ``datautils.py``)
- ``train``     — training/eval engine with Orbax checkpointing and fully
                  on-chip autoregressive rollouts (reference: ``trainer.py``)
"""

__version__ = "0.1.0"
