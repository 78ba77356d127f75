// fp32 fused DeltaGRU layer step for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltagru_seq.py::_kernel
// (wrapper _fused_step, public entry deltagru_seq_step). It computes the same
// function: walk only the fired block_k column blocks of the concatenated
// [3, Hp, Ip+Hk] weight volume (Fig. 6), accumulate d @ w.T into the four
// delta memories M_r, M_u, M_xc, M_hc (the candidate gate splits on the x/h
// seam), then run the Fig. 7 activation:
//   r = sigmoid(M_r), u = sigmoid(M_u), c = tanh(M_xc + r * M_hc),
//   h = (1 - u) * c + u * h_prev.
//
// What bounds it on this card: the weight bytes of the fired column blocks.
// At batch 1 a step does 2 operations per fetched 4-byte weight, far below
// the fp32 rate, so the bound is fired weight bytes over memory bandwidth:
// 3 * Hp * block_k * 4 bytes per fired block. At 2L-768H with every block
// fired that is 22.4 MB per step over 3.35 TB/s = 6.7 us. The whole volume
// fits in the 50 MB L2, so steps that repeat may run faster than that.
//
// What the design does about it: the TPU runs the grid (o-block, k-step) in
// order and carries the sum across k in VMEM. Here one warp owns one output
// row o (its three gate rows) and loops over the fired blocks itself, so
// H = 768 rows give 768 warps in 192 blocks of four, enough to cover the 132
// SMs; the packed layout's block_h plays no part. Each lane reads 16 bytes
// of a gate row per load, so a warp reads 512 contiguous bytes along k. Every
// block stages the concatenated deltas of up to kMaxB streams in shared
// memory, marks which block_k column blocks fired in any of them, and
// compacts their ids itself: no host sync, no extra launch, and no column
// block that no stream fired is read. A stream that did not fire a fired
// block multiplies its own zeros into the sum. More than kMaxB streams are
// taken kMaxB at a time. Simple first: no TMA, no wgmma, no pipelining.

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

__global__ void __launch_bounds__(kWarps * 32) deltagru_seq_kernel(
    const float* __restrict__ w, const float* __restrict__ m_prev,
    const float* __restrict__ h_prev, const float* __restrict__ dx,
    const float* __restrict__ dh, float* __restrict__ m_out,
    float* __restrict__ h_out, int B, int I, int H, int Hp, int K, int ip,
    int block_k, int chunk) {
  extern __shared__ float4 smem4[];
  const int nbk_x = ip / block_k;
  float* d_s = reinterpret_cast<float*>(smem4);          // [chunk][K]
  int* fired = reinterpret_cast<int*>(d_s + chunk * K);  // [nbk]
  int* ids = fired + K / block_k;                        // [nbk]
  __shared__ int n_active;

  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float* w_r = w + (size_t)o * K;
  const float* w_u = w + ((size_t)Hp + o) * K;
  const float* w_c = w + ((size_t)2 * Hp + o) * K;

  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int bc = min(chunk, B - b0);
    delta_walk::stage_fired_blocks(dx, dh, d_s, fired, ids, &n_active, b0,
                                   bc, I, H, K, ip, block_k);
    if (o < H) {
      float acc_r[kMaxB], acc_u[kMaxB], acc_xc[kMaxB], acc_hc[kMaxB];
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb)
        acc_r[bb] = acc_u[bb] = acc_xc[bb] = acc_hc[bb] = 0.0f;
      for (int j = 0; j < n_active; ++j) {
        const int kb = ids[j];
        const bool is_x = kb < nbk_x;  // block left of the x/h seam
        for (int c = lane * 4; c < block_k; c += 128) {
          const int k = kb * block_k + c;
          const float4 wr = __ldg(reinterpret_cast<const float4*>(w_r + k));
          const float4 wu = __ldg(reinterpret_cast<const float4*>(w_u + k));
          const float4 wc = __ldg(reinterpret_cast<const float4*>(w_c + k));
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb) {
            if (bb < bc) {
              const float4 d =
                  *reinterpret_cast<const float4*>(d_s + bb * K + k);
              acc_r[bb] += dot4(d, wr);
              acc_u[bb] += dot4(d, wu);
              const float pc = dot4(d, wc);
              if (is_x) acc_xc[bb] += pc;
              else acc_hc[bb] += pc;
            }
          }
        }
      }
      delta_walk::warp_sum(acc_r);
      delta_walk::warp_sum(acc_u);
      delta_walk::warp_sum(acc_xc);
      delta_walk::warp_sum(acc_hc);
      // Fig. 7 activation: lane bb finishes stream b0 + bb.
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb == lane && bb < bc) {
          const size_t mb = (size_t)(b0 + bb) * 4 * H;
          const float m_r = m_prev[mb + o] + acc_r[bb];
          const float m_u = m_prev[mb + H + o] + acc_u[bb];
          const float m_xc = m_prev[mb + 2 * H + o] + acc_xc[bb];
          const float m_hc = m_prev[mb + 3 * H + o] + acc_hc[bb];
          const float r = sigmoid_f(m_r);
          const float u = sigmoid_f(m_u);
          // no FMA contraction: round each product as the plain version does
          const float c = tanhf(__fadd_rn(m_xc, __fmul_rn(r, m_hc)));
          const float hp = h_prev[(size_t)(b0 + bb) * H + o];
          m_out[mb + o] = m_r;
          m_out[mb + H + o] = m_u;
          m_out[mb + 2 * H + o] = m_xc;
          m_out[mb + 3 * H + o] = m_hc;
          h_out[(size_t)(b0 + bb) * H + o] =
              __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c), __fmul_rn(u, hp));
        }
      }
    }
    __syncthreads();  // the next pass overwrites the staged deltas
  }
}

}  // namespace

// One fp32 fused layer step on encoded deltas.
//   w [3, Hp, K] (K = ip + hk), m_prev/m_out [B, 4H], h_prev/h_out [B, H],
//   dx [B, I], dh [B, H]; all fp32, contiguous, 16-byte aligned.
// Requires block_k % 4 == 0 and K % block_k == 0. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int deltagru_seq_step_f32(const void* w, const void* m_prev,
                                     const void* h_prev, const void* dx,
                                     const void* dh, void* m_out, void* h_out,
                                     int B, int I, int H, int Hp, int K,
                                     int ip, int block_k, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (block_k % 4 || K % block_k || ip % block_k)
    return (int)cudaErrorInvalidValue;
  int chunk = 0;
  size_t smem = 0;
  const cudaError_t err = delta_walk::size_launch(deltagru_seq_kernel, B, K,
                                                  block_k, &chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kWarps - 1) / kWarps);
  deltagru_seq_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)m_prev, (const float*)h_prev,
      (const float*)dx, (const float*)dh, (float*)m_out, (float*)h_out, B, I,
      H, Hp, K, ip, block_k, chunk);
  return (int)cudaGetLastError();
}
