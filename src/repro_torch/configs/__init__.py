"""Model configurations: the paper's own networks (``edgedrnn``), the ten
architecture configs of the LM zoo (one module each) and their registry
(``registry.get_config(arch)``)."""
