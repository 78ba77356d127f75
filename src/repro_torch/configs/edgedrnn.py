"""The paper's own accelerator workloads (DeltaGRU stacks, Table II)."""
from repro_torch.models.gru_rnn import PAPER_NETWORKS, GruTaskConfig  # noqa: F401  (re-export)

CONFIG_2L768H = PAPER_NETWORKS["2L-768H"]
CONFIG_GAS = PAPER_NETWORKS["2L-256H-GAS"]
