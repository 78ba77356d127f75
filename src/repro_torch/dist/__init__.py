"""Distribution substrate: delta gradient compression with error feedback
(:mod:`repro_torch.dist.grad_compress`)."""
