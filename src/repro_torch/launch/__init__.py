"""Launchers: ``python -m repro_torch.launch.serve --arch <id>`` brings up
the LM serving path, ``python -m repro_torch.launch.train --arch <id>``
trains an arch of the registry."""
