"""The port's telemetry: the typed metrics registry (``obs/metrics.py``), the
span tracer with its Chrome-trace export and the profiler spans of the fused
decode loop (``obs/trace.py``), its terminal report (``obs/trace_report.py``)
and the FP8 pool probe (``obs/quant_health.py``)."""
