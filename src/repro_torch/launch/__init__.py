"""Entry points: ``python -m repro_torch.launch.train``, and the
production meshes (``mesh``)."""
