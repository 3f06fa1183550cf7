"""Host-side data handling of the port: audio decoding, collation,
length-bucketed batching, packing and the pipeline helpers (counterparts of
``sonar_tpu.data``'s modules)."""
