"""Parameter initialization with the reference's semantics.

normal(initial_mean, initial_std) by default with ``initial_std =
1/sqrt(fan_in)``, uniform on request, constant for biases. Random values
come from an explicit ``torch.Generator``; they differ from the JAX
package's threefry stream, so parity tests carry parameters across by name
(``compat/from_jax.py``) instead of comparing initialisations.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def default_std(shape: Sequence[int]) -> float:
    """1/sqrt(fan_in); fan_in = product of all but the last dim."""
    if len(shape) <= 1:
        return 1.0
    fan_in = 1
    for d in shape[:-1]:
        fan_in *= d
    return 1.0 / math.sqrt(max(fan_in, 1))


def init_param(
    generator: torch.Generator,
    shape: Sequence[int],
    *,
    init: str = "normal",
    initial_mean: float = 0.0,
    initial_std: Optional[float] = None,
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """One parameter, drawn on the generator's device and moved to
    ``device``."""
    shape = tuple(shape)
    if init in ("zeros", "const"):
        return torch.full(shape, float(initial_mean), dtype=dtype,
                          device=device)
    if initial_std is None:
        initial_std = default_std(shape)
    gen_device = generator.device
    if init == "uniform":
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=gen_device)
        out = (initial_mean - initial_std) + 2.0 * initial_std * u
    else:
        out = initial_mean + initial_std * torch.randn(
            shape, generator=generator, dtype=dtype, device=gen_device)
    return out.to(device)
