"""The port's fault-tolerance runtime (``repro/runtime/``): preemption
handling and the restart loop."""
