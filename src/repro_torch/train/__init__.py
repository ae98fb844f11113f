"""Training substrate: optimizer, train step, data, checkpoints and fault
tolerance (counterparts of ``repro.train``)."""
