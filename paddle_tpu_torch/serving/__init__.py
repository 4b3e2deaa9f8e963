"""Serving plane, score path: predictor, dynamic batcher, HTTP frontend."""

from paddle_tpu_torch.serving.batcher import ServingEngine  # noqa: F401
from paddle_tpu_torch.serving.errors import (BadRequest,  # noqa: F401
                                             DeadlineExceeded, Overloaded,
                                             ServingError, ShuttingDown)
from paddle_tpu_torch.serving.predictor import ServingPredictor  # noqa: F401
from paddle_tpu_torch.serving.server import (make_server,  # noqa: F401
                                             serve_forever)
