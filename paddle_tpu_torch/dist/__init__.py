"""Checkpointing across a training run (``checkpoint.Checkpointer``)."""
