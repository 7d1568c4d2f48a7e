"""Unified telemetry plane: spans, gossip-health gauges, Perfetto timelines.

The port of the reference's ``repro/telemetry``. One run-scoped sink
(:mod:`~repro_torch.telemetry.core`) instruments the train loop, the gossip
bus, and the simulator at no device cost when disabled; every JSON artifact
carries a :mod:`~repro_torch.telemetry.provenance` header; gossip health
(:mod:`~repro_torch.telemetry.health`) is gauged off the *active* mixing
matrix; sim traces export to Chrome-trace/Perfetto JSON
(:mod:`~repro_torch.telemetry.perfetto`); and ``python -m
repro_torch.telemetry.report <run-dir>`` (:mod:`~repro_torch.telemetry.report`)
summarizes a traced run.
"""
from repro_torch.telemetry.core import (NULL, NullTelemetry, Telemetry, enabled,
                                        get, install, run)
from repro_torch.telemetry.health import (DEFAULT_GAMMA, HealthConfig,
                                          active_matrix, effective_neighbors,
                                          health_gauges, round_bytes_by_class)
from repro_torch.telemetry.perfetto import (save_perfetto, trace_to_perfetto,
                                            validate_chrome_trace)
from repro_torch.telemetry.provenance import (SCHEMA_VERSION, config_digest,
                                              provenance, stamp)

__all__ = [
    "Telemetry", "NullTelemetry", "NULL", "get", "install", "enabled", "run",
    "provenance", "stamp", "config_digest", "SCHEMA_VERSION",
    "HealthConfig", "health_gauges", "effective_neighbors", "active_matrix",
    "round_bytes_by_class", "DEFAULT_GAMMA",
    "trace_to_perfetto", "save_perfetto", "validate_chrome_trace",
]
