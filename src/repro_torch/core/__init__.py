"""Delta encoding, delta-linear layers, thresholds, sparsity metrics, the
performance model, the backend registry, the DeltaGRU, DeltaLSTM, delta
RWKV6 and delta RG-LRU stacks and compiled programs.

The public names of :mod:`repro.core`, re-exported; the perf model's
accelerator section under the card's names (``GpuChipSpec``, ``H100``,
``gpu_batch1_gru_roofline``, ``batch_sweep``)."""
from repro_torch.core.backends import (BackendSpec, backend_names,
                                       get_backend, list_backends,
                                       register_backend, registered_backends,
                                       unregister_backend)
from repro_torch.core.delta import (DeltaState, delta_encode,
                                    delta_encode_sequence, delta_encode_ste,
                                    init_delta_state,
                                    reconstruct_from_deltas)
from repro_torch.core.delta_dense import (DeltaLinearState, delta_linear,
                                          delta_linear_reference,
                                          init_delta_linear_state)
from repro_torch.core.deltagru import (DeltaGruStackState, GruLayerParams,
                                       deltagru_sequence, deltagru_step,
                                       gru_sequence, gru_step,
                                       init_deltagru_stack_state,
                                       init_deltagru_state, init_gru_layer,
                                       init_gru_stack)
from repro_torch.core.deltalstm import (DeltaLstmStackState, LstmLayerParams,
                                        deltalstm_sequence,
                                        deltalstm_stack_step, deltalstm_step,
                                        init_deltalstm_stack_state,
                                        init_deltalstm_state, init_lstm_layer,
                                        init_lstm_stack, lstm_sequence,
                                        lstm_stack_m_init, pack_lstm_stack)
from repro_torch.core.perf_model import (EDGEDRNN, H100, AcceleratorSpec,
                                         GpuChipSpec, batch_sweep,
                                         delta_unit_latency_cycles,
                                         dram_traffic_bytes_per_timestep,
                                         estimate_stack,
                                         gpu_batch1_gru_roofline,
                                         normalized_batch1_throughput)
from repro_torch.core.program import (DeltaGruProgram, DeltaGruProgramState,
                                      DeltaProgram, DeltaProgramState,
                                      compile_delta_program,
                                      compile_deltagru, infer_cell)
from repro_torch.core.sparsity import (CELL_GATES, GruDims, cell_dims,
                                       effective_sparsity, fraction_zeros,
                                       gamma_from_fired, lstm_dims)
from repro_torch.core.thresholds import (ThresholdPolicy, dynamic_threshold,
                                         layer_theta, q88)
