// fp32 fused DeltaGRU layer step for Hopper (sm_90a): the G = 3 instance of
// the template in delta_step_f32.cuh (its head note says what bounds the
// step on this card and what the design does about it).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltagru_seq.py::_kernel
// (wrapper _fused_step, public entry deltagru_seq_step). It computes the
// same function: walk only the fired block_k column blocks of the
// concatenated [3, Hp, Ip+Hk] weight volume (gate-major r, u, c rows),
// accumulate d @ w.T into M_r and M_u, and the candidate row into M_xc left
// of the x/h seam and M_hc right of it, then the Fig. 7 activation
//   r, u = sigmoid(M_r, M_u), c = tanh(M_xc + r * M_hc),
//   h = (1 - u) * c + u * h_prev.

#include "delta_step_f32.cuh"

// One fp32 fused GRU layer step on encoded deltas.
//   w [3, Hp, K] (K = ip + hk), m_prev/m_out [B, 4H], h_prev/h_out [B, H],
//   dx [B, I], dh [B, H]; all fp32, contiguous, 16-byte aligned.
//   instance (0 one-stream, 1 tile), chunk (streams a pass), smem (dynamic
//   shared memory, bytes) and device (the current device's index) are the
//   host's launch plan (repro_torch/kernels/delta_step_f32.py).
// Requires block_k % 4 == 0, K % block_k == 0 and ip % block_k == 0 (the
// seam on a block boundary). Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel cannot
// run.
extern "C" int deltagru_seq_step_f32(const void* w, const void* m_prev,
                                     const void* h_prev, const void* dx,
                                     const void* dh, void* m_out, void* h_out,
                                     int B, int I, int H, int Hp, int K,
                                     int ip, int block_k, int instance,
                                     int chunk, int smem, int device,
                                     void* stream) {
  const delta_step_f32::StepArgs a{
      (const float*)w,  (const float*)m_prev, (const float*)h_prev,
      (const float*)dx, (const float*)dh,     (float*)m_out,
      (float*)h_out,    nullptr,              B, I, H, Hp, K, ip, block_k,
      chunk};
  return delta_step_f32::launch_step<3>(a, instance, smem, device, stream);
}
