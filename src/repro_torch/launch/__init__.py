"""Command-line launchers (``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train``), the mesh descriptor they name
(:mod:`repro_torch.launch.mesh`), and the dry run
(:mod:`repro_torch.launch.dryrun`: each cell's step traced on ``meta``
tensors), its op-level cost counter (:mod:`repro_torch.launch.op_analysis`)
and the card's roofline (:mod:`repro_torch.launch.roofline`)."""
