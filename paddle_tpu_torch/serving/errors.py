"""Typed serving errors — the wire contract for everything that is not a
500. The port's copy of the part of ``paddle_tpu/serving/errors.py`` its
score path raises; the codes and bodies are the same, so the JAX
package's ``ServingClient`` rebuilds them."""

from __future__ import annotations

from typing import Optional


class ServingError(Exception):
    """Base of the typed family. ``status`` is the HTTP status; ``code``
    the stable machine-readable discriminator in the JSON body."""

    status = 500
    code = "internal"

    def __init__(self, message: str,
                 retry_after_ms: Optional[float] = None,
                 allowed: Optional[dict] = None):
        super().__init__(message)
        self.retry_after_ms = retry_after_ms
        self.allowed = allowed

    def to_wire(self) -> dict:
        body = {"code": self.code, "message": str(self)}
        if self.retry_after_ms is not None:
            body["retry_after_ms"] = round(float(self.retry_after_ms), 1)
        if self.allowed is not None:
            body["allowed"] = self.allowed
        return {"error": body}


class BadRequest(ServingError):
    """Malformed or inadmissible request: wrong slot count, a sequence
    longer than the largest warmed length bucket, an id outside the
    declared range. 400."""

    status = 400
    code = "bad_request"


class DeadlineExceeded(ServingError):
    """The request's deadline passed before its answer. 504."""

    status = 504
    code = "deadline_exceeded"


class Overloaded(ServingError):
    """Load shed: the queue is full. Carries ``retry_after_ms``. 429."""

    status = 429
    code = "overloaded"


class ShuttingDown(Overloaded):
    """Admission closed because the server is draining; in-flight work
    still completes. 429."""

    code = "shutting_down"
