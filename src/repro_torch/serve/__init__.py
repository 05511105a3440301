"""Always-on serving layer over the Bind executor (port of ``repro.serve``).

Usage::

    from repro_torch.serve import ServingRuntime

    with ServingRuntime(backend="fused") as rt:
        s = rt.session()
        fut = s.submit(lambda sess: decode_step(sess))
        value = fut.result()
        print(rt.metrics.summary())

See :mod:`repro_torch.serve.runtime` for the architecture.
"""

from .metrics import ServeMetrics
from .runtime import ServingRuntime
from .session import (RuntimeClosed, RuntimeOverloaded, ServeError,
                      ServeRequest, Session, SessionPoisoned)

__all__ = ["ServingRuntime", "ServeMetrics", "Session", "ServeRequest",
           "ServeError", "RuntimeClosed", "RuntimeOverloaded",
           "SessionPoisoned"]
