"""Local optimizers of the port (``repro.optim``)."""
