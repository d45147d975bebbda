"""Training: the γ-weighted sequence loss, the family adapters, AdamW with
OneCycle and global-norm clipping, the train step and its epoch loop, and
checkpoints (counterpart of ``eemflow_tpu/train/``)."""
