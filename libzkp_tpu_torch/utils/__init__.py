"""Cross-cutting utilities: errors, limits, the proof envelope, validation and
byte codecs (copies of the JAX package's ``libzkp_tpu/utils`` modules)."""
