"""Offline pipelines (counterparts of mmd_tpu/pipelines): raw Factify TSV ->
preprocessed CSV -> captions -> embedded or raw sample stores -> retrieval
corpora -> evaluation; run_all drives them end to end."""
