"""Multi-device execution: device meshes, their placements, the named-axis
collectives, the multi-process bootstrap and the multi-device dry run (port
of the JAX package's ``libzkp_tpu/parallel``)."""
