"""Launchers: ``python -m repro_torch.launch.serve --arch <id>`` brings up
the LM serving path."""
