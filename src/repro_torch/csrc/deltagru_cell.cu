// Fused DeltaGRU activation pipeline (paper Fig. 7, Eq. 3) for Hopper
// (sm_90a): from the delta memories m [B, 4H] (r, u, xc, hc) and the two
// matvec results zx = W_x dx, zh = W_h dh [B, 3H] (r, u, c),
//   M_r += zx_r + zh_r, M_u += zx_u + zh_u, M_xc += zx_c, M_hc += zh_c,
//   r = sigmoid(M_r), u = sigmoid(M_u), c = tanh(M_xc + r * M_hc),
//   h = (1 - u) * c + u * h_prev.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltagru_cell.py::_kernel
// (pallas_call in deltagru_act), which tiles the hidden dim in 128-lane
// blocks over [B, g, block_h] gate views.
//
// What bounds it on this card: bytes. 16 floats move per (b, h) (11 read,
// 5 written) for a few dozen operations; at 2L-768H and B = 1 that is
// 49 KB, 0.015 us at 3.35 TB/s, below what a launch costs.
//
// What the design does about it: one thread per (b, h), reading each
// operand once and writing each result once, with exactly the arithmetic of
// the plain version (each sum and product rounded on its own; sigmoid as
// 1 / (1 + exp(-x)), IEEE expf / tanhf).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads) deltagru_act_kernel(
    const float* __restrict__ m_prev, const float* __restrict__ zx,
    const float* __restrict__ zh, const float* __restrict__ h_prev,
    float* __restrict__ m_out, float* __restrict__ h_out, int B, int H) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;  // b * H + o
  if (idx >= B * H) return;
  const int b = idx / H;
  const int o = idx - b * H;
  const float* m = m_prev + (size_t)b * 4 * H;
  const float* x = zx + (size_t)b * 3 * H;
  const float* g = zh + (size_t)b * 3 * H;
  const float m_r = __fadd_rn(__fadd_rn(m[o], x[o]), g[o]);
  const float m_u = __fadd_rn(__fadd_rn(m[H + o], x[H + o]), g[H + o]);
  const float m_xc = __fadd_rn(m[2 * H + o], x[2 * H + o]);
  const float m_hc = __fadd_rn(m[3 * H + o], g[2 * H + o]);
  const float r = sigmoid_f(m_r);
  const float u = sigmoid_f(m_u);
  const float c = tanhf(__fadd_rn(m_xc, __fmul_rn(r, m_hc)));
  float* mo = m_out + (size_t)b * 4 * H;
  mo[o] = m_r;
  mo[H + o] = m_u;
  mo[2 * H + o] = m_xc;
  mo[3 * H + o] = m_hc;
  h_out[idx] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c),
                         __fmul_rn(u, h_prev[idx]));
}

}  // namespace

// m_prev, m_out [B, 4H]; zx, zh [B, 3H]; h_prev, h_out [B, H]; all fp32,
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int deltagru_act_f32(const void* m_prev, const void* zx,
                                const void* zh, const void* h_prev,
                                void* m_out, void* h_out, int B, int H,
                                void* stream) {
  if (B <= 0 || H <= 0) return 0;
  const int blocks = (B * H + kThreads - 1) / kThreads;
  deltagru_act_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m_prev, (const float*)zx, (const float*)zh,
      (const float*)h_prev, (float*)m_out, (float*)h_out, B, H);
  return (int)cudaGetLastError();
}
