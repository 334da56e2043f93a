"""Entry points of the port: :mod:`~repro_torch.launch.serve`, the serving
launcher."""
