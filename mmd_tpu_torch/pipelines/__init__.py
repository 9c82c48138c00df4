"""Offline pipelines (counterparts of mmd_tpu/pipelines): raw Factify TSV ->
preprocessed CSV -> raw sample store."""
