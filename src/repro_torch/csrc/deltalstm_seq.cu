// fp32 fused DeltaLSTM layer step for Hopper (sm_90a): the G = 4 instance of
// the template in delta_step_f32.cuh (its head note says what bounds the
// step on this card and what the design does about it).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltalstm_seq.py::
// _lstm_kernel (wrapper _fused_lstm_step, public entry deltalstm_seq_step).
// It computes the same function: walk only the fired block_k column blocks
// of the concatenated [4, Hp, Ip+Hk] weight volume (gate-major i, f, g, o
// rows), accumulate d @ w.T into the four delta memories M_i, M_f, M_g, M_o
// (each takes both the x and the h stream, so there is no seam routing),
// then i, f, o = sigmoid(M), g = tanh(M_g), c = f * c_prev + i * g,
// h = o * tanh(c). There is no h_prev operand: h = o * tanh(c) reads only
// the cell state.

#include "delta_step_f32.cuh"

// One fp32 fused LSTM layer step on encoded deltas.
//   w [4, Hp, K] (K = ip + hk), m_prev/m_out [B, 4H], c_prev/c_out/h_out
//   [B, H], dx [B, I], dh [B, H]; all fp32, contiguous, 16-byte aligned.
//   instance (0 one-stream, 1 tile), chunk (streams a pass), smem (dynamic
//   shared memory, bytes) and device (the current device's index) are the
//   host's launch plan (repro_torch/kernels/delta_step_f32.py).
// Requires block_k % 4 == 0 and K % block_k == 0. Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel
// cannot run.
extern "C" int deltalstm_seq_step_f32(const void* w, const void* m_prev,
                                      const void* c_prev, const void* dx,
                                      const void* dh, void* m_out,
                                      void* h_out, void* c_out, int B, int I,
                                      int H, int Hp, int K, int ip,
                                      int block_k, int instance, int chunk,
                                      int smem, int device, void* stream) {
  const delta_step_f32::StepArgs a{
      (const float*)w,  (const float*)m_prev, (const float*)c_prev,
      (const float*)dx, (const float*)dh,     (float*)m_out,
      (float*)h_out,    (float*)c_out,        B, I, H, Hp, K, ip, block_k,
      chunk};
  return delta_step_f32::launch_step<4>(a, instance, smem, device, stream);
}
