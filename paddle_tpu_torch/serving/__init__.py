"""Serving plane, score and generate paths: predictor (with the quantized
tier), dynamic batcher (with continuous batching), metrics, HTTP
frontend."""

from paddle_tpu_torch.serving.batcher import ServingEngine  # noqa: F401
from paddle_tpu_torch.serving.errors import (BadRequest,  # noqa: F401
                                             DeadlineExceeded, Overloaded,
                                             QuantGateError, ServingError,
                                             ShuttingDown)
from paddle_tpu_torch.serving.metrics import ServingMetrics  # noqa: F401
from paddle_tpu_torch.serving.predictor import ServingPredictor  # noqa: F401
from paddle_tpu_torch.serving.server import (make_server,  # noqa: F401
                                             serve_forever)
