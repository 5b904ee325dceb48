"""LM training: AdamW on float32 masters (``optimizer``), checkpoints in the
JAX package's layout (``checkpoint``) and the train step and host loop
(``trainer``). ``python -m repro_torch.train`` trains a ~110M model."""
