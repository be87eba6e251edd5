"""Executable serving tier: partition-owning workers passing real batons.

Counterpart of ``repro/serve_async`` in thread mode.  Layers (each file's
docstring carries the detail):

* ``runtime``  — per-query execution over the engine's own primitives
* ``wire``     — the baton as bytes (measured vs ``envelope_bytes``)
* ``queues``   — per-worker two-class inboxes (hand-off priority, bounded
  admission, reserved headroom)
* ``worker``   — the service loop and its thread launcher
* ``tier``     — ``AsyncServingTier``: client, pacing, results, accounting

Entry points: ``api.deployment.run_exec`` and
``launch/serve.py --exec-workers``.
"""

from repro_torch.serve_async.tier import (    # noqa: F401
    AsyncServingTier, ExecRunResult,
)
from repro_torch.serve_async.wire import (    # noqa: F401
    decode_baton, decode_frame, encode_baton, encode_frame,
)
