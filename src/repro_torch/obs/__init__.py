"""Run-wide tracing & live telemetry (counterpart of ``repro/obs``).

  * ``trace``     — ``TRACE``, the process-local bounded ring-buffer
    recorder every hook writes through (disabled: a no-op attribute
    check),
  * ``collect``   — ``TraceCollector`` merges drained ring buffers from
    many processes into one run timeline (dedup by ``(src, seq)``),
    plus the ``MetricsSampler`` interval thread,
  * ``export``    — Chrome trace JSON / JSONL writers and the
    format-sniffing reader (byte for byte the reference's output),
  * ``summarize`` — the paper's quantities (wait fraction, threshold
    timeline, staleness percentiles) from a trace;
    ``python -m repro_torch.obs summarize <trace>`` on the CLI.

Everything here is stdlib-only: spawned worker processes import it
before they touch torch.
"""

from repro_torch.obs.collect import MetricsSampler, TraceCollector
from repro_torch.obs.export import (read_jsonl, read_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.summarize import format_summary, summarize
from repro_torch.obs.trace import TRACE, TraceRecorder

__all__ = [
    "TRACE",
    "TraceRecorder",
    "TraceCollector",
    "MetricsSampler",
    "write_chrome_trace",
    "write_jsonl",
    "read_jsonl",
    "read_trace",
    "summarize",
    "format_summary",
]
