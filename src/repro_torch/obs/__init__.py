"""repro_torch.obs: telemetry (structured metrics, spans, the profiler
hook), as ``src/repro/obs``. Entry points:

  Telemetry / make_telemetry   the bus (sinks, rounds, stats, spans, close)
  NULL                         the shared no-op bus of uninstrumented runs
  JsonlSink / StdoutSink / MemorySink
  run_manifest                 the schema-versioned run header
  StatAccum                    the on-device [K, S] stat ring, one host
                               copy every K rounds (ring_update and
                               ring_close drive it from a round loop)
  ChunkStats                   a row a round inside a mega-scan chunk,
                               one stats record a chunk
  progress_line                the launchers' progress formatter
"""
from repro_torch.obs.devstats import (STAT_FIELDS, ChunkStats, StatAccum,
                                      ring_close, ring_update, stat_row)
from repro_torch.obs.progress import progress_line
from repro_torch.obs.telemetry import (NULL, SCHEMA, JsonlSink, MemorySink,
                                       NullTelemetry, StdoutSink, Telemetry,
                                       make_telemetry, run_manifest)

__all__ = [
    "NULL", "SCHEMA", "JsonlSink", "MemorySink", "NullTelemetry",
    "StdoutSink", "Telemetry", "make_telemetry", "run_manifest",
    "STAT_FIELDS", "ChunkStats", "StatAccum", "ring_close", "ring_update",
    "stat_row",
    "progress_line",
]
