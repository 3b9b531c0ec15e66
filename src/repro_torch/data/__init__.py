"""The port's synthetic, resumable training data (``repro/data/``)."""
