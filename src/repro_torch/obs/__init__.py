"""The port's telemetry: the typed metrics registry (``obs/metrics.py``)."""
