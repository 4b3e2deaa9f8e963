"""Fused optimizer-update kernels (``paddle_tpu/kernels/opt_update.py``'s
counterpart)."""
