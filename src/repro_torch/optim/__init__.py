"""The port's optimizer (``repro/optim/``): AdamW with global-norm clipping,
the warmup-cosine schedule, and INT8 error-feedback gradient compression."""
