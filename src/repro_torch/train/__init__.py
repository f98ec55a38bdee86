"""Training-side consumers of the port's collectives: the checkpoint
restore fan-out (:mod:`repro_torch.train.restore_broadcast`)."""
