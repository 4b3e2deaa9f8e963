"""Model builders over the port's DSL."""

from paddle_tpu_torch.models.lenet import lenet_mnist  # noqa: F401
from paddle_tpu_torch.models.resnet import resnet  # noqa: F401
from paddle_tpu_torch.models.vae import vae, vae_decoder  # noqa: F401
