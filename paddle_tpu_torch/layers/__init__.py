"""Layer implementations; importing this package registers every ported
layer type."""

from paddle_tpu_torch.layers import activations  # noqa: F401
from paddle_tpu_torch.layers import attention  # noqa: F401
from paddle_tpu_torch.layers import chain  # noqa: F401
from paddle_tpu_torch.layers import common  # noqa: F401
from paddle_tpu_torch.layers import conv  # noqa: F401
from paddle_tpu_torch.layers import cost  # noqa: F401
from paddle_tpu_torch.layers import detection  # noqa: F401
from paddle_tpu_torch.layers import group  # noqa: F401
from paddle_tpu_torch.layers import misc  # noqa: F401
from paddle_tpu_torch.layers import moe  # noqa: F401
from paddle_tpu_torch.layers import norm  # noqa: F401
from paddle_tpu_torch.layers import pool  # noqa: F401
from paddle_tpu_torch.layers import recurrent  # noqa: F401
from paddle_tpu_torch.layers import sampling  # noqa: F401
from paddle_tpu_torch.layers import sequence  # noqa: F401
