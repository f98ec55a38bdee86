"""Command-line launchers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``) and the mesh descriptor they
name (:mod:`repro_torch.launch.mesh`)."""
