"""Parallel building blocks: the single-device top-1 MoE FFN
(``moe.py``)."""
