// fp32 fused DeltaLSTM layer step for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltalstm_seq.py::
// _lstm_kernel (wrapper _fused_lstm_step, public entry deltalstm_seq_step). It
// computes the same function: walk only the fired block_k column blocks of
// the concatenated [4, Hp, Ip+Hk] weight volume (gate-major i, f, g, o rows),
// accumulate d @ w.T into the four delta memories M_i, M_f, M_g, M_o (each
// takes both the x and the h stream, so there is no seam routing), then
//   i, f, o = sigmoid(M), g = tanh(M_g), c = f * c_prev + i * g,
//   h = o * tanh(c).
// There is no h_prev operand: h = o * tanh(c) reads only the cell state.
//
// What bounds it on this card: the weight bytes of the fired column blocks,
// 4 * Hp * block_k * 4 bytes per fired block. At batch 1 a step does 2
// operations per fetched 4-byte weight, far below the fp32 rate, so the bound
// is fired weight bytes over memory bandwidth: at 2L-768H with every block
// fired, the real rows and columns come to 4 * 768 * (40 + 768 + 1536) * 4 B =
// 28.8 MB per step, 8.6 us at 3.35 TB/s. The packed volumes (29.9 MB) fit in
// the 50 MB L2, so steps that repeat may run faster than that.
//
// What the design does about it: the walk of deltagru_seq.cu, shared through
// delta_walk.cuh. One warp owns one output row o (its four gate rows) and
// loops over the fired blocks itself; each lane reads 16 bytes of each gate
// row per load, so a warp reads 512 contiguous bytes along k. Each thread
// block stages the concatenated deltas of up to kMaxB streams in shared
// memory and compacts the ids of the blocks any of them fired, on the device:
// no host sync, no extra launch, no read of a block that no stream fired.
// Four accumulators per stream, as the GRU kernel keeps (M_r, M_u, M_xc,
// M_hc). The two blend lines round each product (__fmul_rn / __fadd_rn, no
// FMA contraction); expf / tanhf are IEEE (no fast math). Simple first: no
// TMA, no wgmma, no pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

using delta_walk::kMaxB;
using delta_walk::kWarps;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__global__ void __launch_bounds__(kWarps * 32) deltalstm_seq_kernel(
    const float* __restrict__ w, const float* __restrict__ m_prev,
    const float* __restrict__ c_prev, const float* __restrict__ dx,
    const float* __restrict__ dh, float* __restrict__ m_out,
    float* __restrict__ h_out, float* __restrict__ c_out, int B, int I, int H,
    int Hp, int K, int ip, int block_k, int chunk) {
  extern __shared__ float4 smem4[];
  float* d_s = reinterpret_cast<float*>(smem4);          // [chunk][K]
  int* fired = reinterpret_cast<int*>(d_s + chunk * K);  // [nbk]
  int* ids = fired + K / block_k;                        // [nbk]
  __shared__ int n_active;

  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* w_i = w + (size_t)o * K;
  const float* w_f = w + ((size_t)Hp + o) * K;
  const float* w_g = w + ((size_t)2 * Hp + o) * K;
  const float* w_o = w + ((size_t)3 * Hp + o) * K;

  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int bc = min(chunk, B - b0);
    delta_walk::stage_fired_blocks(dx, dh, d_s, fired, ids, &n_active, b0,
                                   bc, I, H, K, ip, block_k);
    if (o < H) {
      float acc_i[kMaxB], acc_f[kMaxB], acc_g[kMaxB], acc_o[kMaxB];
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb)
        acc_i[bb] = acc_f[bb] = acc_g[bb] = acc_o[bb] = 0.0f;
      for (int j = 0; j < n_active; ++j) {
        const int kb = ids[j];
        for (int c = lane * 4; c < block_k; c += 128) {
          const int k = kb * block_k + c;
          const float4 wi = __ldg(reinterpret_cast<const float4*>(w_i + k));
          const float4 wf = __ldg(reinterpret_cast<const float4*>(w_f + k));
          const float4 wg = __ldg(reinterpret_cast<const float4*>(w_g + k));
          const float4 wo = __ldg(reinterpret_cast<const float4*>(w_o + k));
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb) {
            if (bb < bc) {
              const float4 d =
                  *reinterpret_cast<const float4*>(d_s + bb * K + k);
              acc_i[bb] += dot4(d, wi);
              acc_f[bb] += dot4(d, wf);
              acc_g[bb] += dot4(d, wg);
              acc_o[bb] += dot4(d, wo);
            }
          }
        }
      }
      delta_walk::warp_sum(acc_i);
      delta_walk::warp_sum(acc_f);
      delta_walk::warp_sum(acc_g);
      delta_walk::warp_sum(acc_o);
      // activation: lane bb finishes stream b0 + bb
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb == lane && bb < bc) {
          const size_t mb = (size_t)(b0 + bb) * 4 * H;
          const size_t hb = (size_t)(b0 + bb) * H + o;
          const float m_i = m_prev[mb + o] + acc_i[bb];
          const float m_f = m_prev[mb + H + o] + acc_f[bb];
          const float m_g = m_prev[mb + 2 * H + o] + acc_g[bb];
          const float m_o = m_prev[mb + 3 * H + o] + acc_o[bb];
          const float gi = sigmoid_f(m_i);
          const float gf = sigmoid_f(m_f);
          const float gg = tanhf(m_g);
          const float go = sigmoid_f(m_o);
          // no FMA contraction: round each product as the plain version does
          const float c =
              __fadd_rn(__fmul_rn(gf, c_prev[hb]), __fmul_rn(gi, gg));
          m_out[mb + o] = m_i;
          m_out[mb + H + o] = m_f;
          m_out[mb + 2 * H + o] = m_g;
          m_out[mb + 3 * H + o] = m_o;
          c_out[hb] = c;
          h_out[hb] = __fmul_rn(go, tanhf(c));
        }
      }
    }
    __syncthreads();  // the next pass overwrites the staged deltas
  }
}

}  // namespace

// One fp32 fused LSTM layer step on encoded deltas.
//   w [4, Hp, K] (K = ip + hk), m_prev/m_out [B, 4H], c_prev/c_out/h_out
//   [B, H], dx [B, I], dh [B, H]; all fp32, contiguous, 16-byte aligned.
// Requires block_k % 4 == 0 and K % block_k == 0. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int deltalstm_seq_step_f32(const void* w, const void* m_prev,
                                      const void* c_prev, const void* dx,
                                      const void* dh, void* m_out,
                                      void* h_out, void* c_out, int B, int I,
                                      int H, int Hp, int K, int ip,
                                      int block_k, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (block_k % 4 || K % block_k || ip % block_k)
    return (int)cudaErrorInvalidValue;
  int chunk = 0;
  size_t smem = 0;
  const cudaError_t err = delta_walk::size_launch(deltalstm_seq_kernel, B, K,
                                                  block_k, &chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kWarps - 1) / kWarps);
  deltalstm_seq_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)m_prev, (const float*)c_prev,
      (const float*)dx, (const float*)dh, (float*)m_out, (float*)h_out,
      (float*)c_out, B, I, H, Hp, K, ip, block_k, chunk);
  return (int)cudaGetLastError();
}
