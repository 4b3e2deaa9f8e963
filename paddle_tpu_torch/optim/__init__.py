"""Optimizers and learning-rate schedules (``paddle_tpu/optim``'s
counterpart)."""

from paddle_tpu_torch.optim.optimizers import (AdaDelta, AdaGrad, Adam,
                                               Adamax, DecayedAdaGrad,
                                               Momentum, Optimizer, RMSProp,
                                               create_optimizer)
from paddle_tpu_torch.optim.schedules import learning_rate_at

__all__ = ["AdaDelta", "AdaGrad", "Adam", "Adamax", "DecayedAdaGrad",
           "Momentum", "Optimizer", "RMSProp", "create_optimizer",
           "learning_rate_at"]
