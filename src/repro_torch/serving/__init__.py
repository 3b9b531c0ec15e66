"""The port's continuous-batching serving engine (``repro/serving/``):
allocator, prefix tree, scheduler, speculative proposer, fault plans and
``ServingEngine``."""
