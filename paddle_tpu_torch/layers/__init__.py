"""Layer implementations; importing this package registers every ported
layer type."""

from paddle_tpu_torch.layers import activations  # noqa: F401
from paddle_tpu_torch.layers import common  # noqa: F401
from paddle_tpu_torch.layers import cost  # noqa: F401
from paddle_tpu_torch.layers import recurrent  # noqa: F401
from paddle_tpu_torch.layers import sequence  # noqa: F401
