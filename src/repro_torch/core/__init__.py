"""The pieces of ``repro.core`` the distributed round needs, copied as
plain Python (``repro.core`` imports jax)."""
