"""Model configurations: the paper's own networks (``edgedrnn``) and the
architecture configs of the delta-ized LM cells (``rwkv6_1_6b``,
``recurrentgemma_9b``)."""
