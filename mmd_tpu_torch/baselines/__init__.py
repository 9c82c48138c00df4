"""Prompting baselines (counterparts of mmd_tpu/baselines/prompting.py and
eval_prompting.py) on the captioner's decoder."""
