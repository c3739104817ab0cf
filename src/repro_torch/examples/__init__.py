"""The reference's ``examples/`` as scripts of the port: ``python -m
repro_torch.examples.<name> [--device cpu]`` (each runs on the GPU unless
the CPU is asked for; each ``main(argv)`` returns the exit code)."""
