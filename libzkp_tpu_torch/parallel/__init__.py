"""Multi-device execution: device meshes and the collectives the
mesh-sharded MSM needs (port of the JAX package's ``libzkp_tpu/parallel``)."""
