# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``metricserve`` — the always-on eval-service plane (counterpart of
``torchmetrics_tpu/serve``).

The port's planes (fused, sliced and windowed, durability, sketches and
drift, the guard, live telemetry) compose here into a deployable daemon:
many named durable streams behind one HTTP control plane and a unix-socket
ingest plane, on the card by default. Run it with ``python -m
torchmetrics_tpu_torch.serve serve`` (``--device cpu`` on the host); talk to
it with the same module's ``ctl`` or with the JAX package's
``tools/metricserve.py ctl``: the wire is the same.
"""
from torchmetrics_tpu_torch.serve.daemon import ServeDaemon
from torchmetrics_tpu_torch.serve.federation import FleetAggregator, decode_state
from torchmetrics_tpu_torch.serve.stream import Stream, StreamSpec, decode_batch, resolve_target
from torchmetrics_tpu_torch.serve.wire import WIRE_VERSION, WireError, encode_state

__all__ = [
    "FleetAggregator",
    "ServeDaemon",
    "Stream",
    "StreamSpec",
    "WIRE_VERSION",
    "WireError",
    "decode_batch",
    "decode_state",
    "encode_state",
    "resolve_target",
]
