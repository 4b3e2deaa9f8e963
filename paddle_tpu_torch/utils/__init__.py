"""Host-side utilities of the port: the mask dtype invariant
(``masks.py``) and JAX's dtype promotion where torch refuses mixed
operands (``precision.py``)."""
