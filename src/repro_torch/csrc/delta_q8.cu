// int8 / int4 fused DeltaGRU layer step for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/delta_q8.py::_q8_gru_kernel
// (wrapper _fused_q8_step, public entry deltagru_q8_step) at weight_bits 8 and
// 4. It computes the same function: walk only the fired block_k column blocks
// of the packed [3, Hp, K] volume of int8 codes (or [3, Hp, K/2] nibble-packed
// int4 codes), accumulate the unscaled code-domain products delta * code in
// fp32 (the PE's integer accumulator: every product and partial sum of Q8.8
// deltas and small integer codes is exact, so any summation order gives the
// same bits), route the candidate gate on the x/h seam into M_xc / M_hc, then
// dequantize b4 + s * M and run Fig. 7 on the Q8.8-input / Q1.4-output LUT
// grids, rounding the new h back onto Q8.8.
//
// int4 layout (pack_nibbles): inside each block_k column block, byte j holds
// column j in its low nibble and column j + block_k/2 in its high nibble; a
// nibble n decodes as ((n & 15) ^ 8) - 8.
//
// What bounds it on this card: the fired weight bytes, 3 * Hp * block_k bytes
// per fired block at int8 (half that at int4), over memory bandwidth. At
// 2L-768H with every block fired a step streams 5.6 MB (int8) or 2.8 MB (int4):
// 1.7 us or 0.84 us at 3.35 TB/s. The operations (2 per code per stream) are
// far below any compute rate at batch 1.
//
// What the design does about it: the same walk as deltagru_seq.cu (one warp
// per output row, fired blocks compacted by each thread block on the device,
// deltas staged in shared memory: delta_walk.cuh), with each lane reading
// 4 code bytes (int8) or 2 packed bytes (int4) of a gate row, so a warp
// reads 128 or 64 contiguous bytes per gate row and block. The stage after the sum keeps the
// JAX package's op order and rounding exactly: no FMA contraction on the
// dequant, the candidate sum or the blend (__fmul_rn / __fadd_rn), IEEE
// expf / tanhf / division (no fast math), and rintf (half to even) for every
// grid rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

using delta_walk::kMaxB;
using delta_walk::kWarps;

struct Grid {  // a Qm.n grid: round(v * scale) / scale, clipped to [lo, hi]
  float scale, lo, hi;
};

__device__ __forceinline__ float grid_round(float v, Grid g) {
  const float q = __fdiv_rn(rintf(__fmul_rn(v, g.scale)), g.scale);
  return fminf(fmaxf(q, g.lo), g.hi);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The activation stage shared by the kernel and the exhaustive grid check.
__device__ __forceinline__ float lut_sigmoid(float x, Grid act, Grid lut) {
  return grid_round(sigmoid_f(grid_round(x, act)), lut);
}

__device__ __forceinline__ float lut_tanh(float x, Grid act, Grid lut) {
  return grid_round(tanhf(grid_round(x, act)), lut);
}

__device__ __forceinline__ float nib(int p) { return (float)(((p & 15) ^ 8) - 8); }

template <int BITS>
__global__ void __launch_bounds__(kWarps * 32) delta_q8_gru_kernel(
    const int8_t* __restrict__ w_q, const float* __restrict__ scales,
    const float* __restrict__ b4, const float* __restrict__ m_prev,
    const float* __restrict__ h_prev, const float* __restrict__ dx,
    const float* __restrict__ dh, float* __restrict__ m_out,
    float* __restrict__ h_out, int B, int I, int H, int Hp, int K, int ip,
    int block_k, int chunk, Grid act, Grid lut) {
  extern __shared__ float4 smem4[];
  const int nbk_x = ip / block_k;
  float* d_s = reinterpret_cast<float*>(smem4);          // [chunk][K]
  int* fired = reinterpret_cast<int*>(d_s + chunk * K);  // [nbk]
  int* ids = fired + K / block_k;                        // [nbk]
  __shared__ int n_active;

  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t row = BITS == 8 ? (size_t)K : (size_t)K / 2;  // bytes per row
  const int8_t* w_r = w_q + (size_t)o * row;
  const int8_t* w_u = w_q + ((size_t)Hp + o) * row;
  const int8_t* w_c = w_q + ((size_t)2 * Hp + o) * row;
  const int half = block_k / 2;

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
        const bool is_x = kb < nbk_x;
        const int kbase = kb * block_k;
        if (BITS == 8) {
          for (int c = lane * 4; c < block_k; c += 128) {
            const int k = kbase + c;
            const char4 cr = __ldg(reinterpret_cast<const char4*>(w_r + k));
            const char4 cu = __ldg(reinterpret_cast<const char4*>(w_u + k));
            const char4 cc = __ldg(reinterpret_cast<const char4*>(w_c + k));
#pragma unroll
            for (int bb = 0; bb < kMaxB; ++bb) {
              if (bb < bc) {
                const float4 d =
                    *reinterpret_cast<const float4*>(d_s + bb * K + k);
                acc_r[bb] += d.x * cr.x + d.y * cr.y + d.z * cr.z + d.w * cr.w;
                acc_u[bb] += d.x * cu.x + d.y * cu.y + d.z * cu.z + d.w * cu.w;
                const float pc =
                    d.x * cc.x + d.y * cc.y + d.z * cc.z + d.w * cc.w;
                if (is_x) acc_xc[bb] += pc;
                else acc_hc[bb] += pc;
              }
            }
          }
        } else {
          for (int jj = lane * 2; jj < half; jj += 64) {
            const size_t byte = (size_t)kb * half + jj;
            const char2 pr = __ldg(reinterpret_cast<const char2*>(w_r + byte));
            const char2 pu = __ldg(reinterpret_cast<const char2*>(w_u + byte));
            const char2 pcb = __ldg(reinterpret_cast<const char2*>(w_c + byte));
            // columns kbase+jj, +jj+1 (low nibbles), +half+jj, +half+jj+1 (high)
            const float r0 = nib(pr.x), r1 = nib(pr.y);
            const float r2 = nib(pr.x >> 4), r3 = nib(pr.y >> 4);
            const float u0 = nib(pu.x), u1 = nib(pu.y);
            const float u2 = nib(pu.x >> 4), u3 = nib(pu.y >> 4);
            const float c0 = nib(pcb.x), c1 = nib(pcb.y);
            const float c2 = nib(pcb.x >> 4), c3 = nib(pcb.y >> 4);
#pragma unroll
            for (int bb = 0; bb < kMaxB; ++bb) {
              if (bb < bc) {
                const float2 dl = *reinterpret_cast<const float2*>(
                    d_s + bb * K + kbase + jj);
                const float2 dhi = *reinterpret_cast<const float2*>(
                    d_s + bb * K + kbase + half + jj);
                acc_r[bb] += dl.x * r0 + dl.y * r1 + dhi.x * r2 + dhi.y * r3;
                acc_u[bb] += dl.x * u0 + dl.y * u1 + dhi.x * u2 + dhi.y * u3;
                const float pc =
                    dl.x * c0 + dl.y * c1 + dhi.x * c2 + dhi.y * c3;
                if (is_x) acc_xc[bb] += pc;
                else acc_hc[bb] += pc;
              }
            }
          }
        }
      }
      delta_walk::warp_sum(acc_r);
      delta_walk::warp_sum(acc_u);
      delta_walk::warp_sum(acc_xc);
      delta_walk::warp_sum(acc_hc);
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb == lane && bb < bc) {
          const size_t mb = (size_t)(b0 + bb) * 4 * H;
          // code domain: exact sums
          const float m_r = m_prev[mb + o] + acc_r[bb];
          const float m_u = m_prev[mb + H + o] + acc_u[bb];
          const float m_xc = m_prev[mb + 2 * H + o] + acc_xc[bb];
          const float m_hc = m_prev[mb + 3 * H + o] + acc_hc[bb];
          const float s_r = scales[o];
          const float s_u = scales[Hp + o];
          const float s_c = scales[2 * Hp + o];
          const float sc_r = __fadd_rn(b4[o], __fmul_rn(m_r, s_r));
          const float sc_u = __fadd_rn(b4[Hp + o], __fmul_rn(m_u, s_u));
          const float sc_xc = __fadd_rn(b4[2 * Hp + o], __fmul_rn(m_xc, s_c));
          const float sc_hc = __fadd_rn(b4[3 * Hp + o], __fmul_rn(m_hc, s_c));
          const float r = lut_sigmoid(sc_r, act, lut);
          const float u = lut_sigmoid(sc_u, act, lut);
          const float c = lut_tanh(__fadd_rn(sc_xc, __fmul_rn(r, sc_hc)), act,
                                   lut);
          const float hp = h_prev[(size_t)(b0 + bb) * H + o];
          const float hn = grid_round(
              __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c), __fmul_rn(u, hp)),
              act);
          m_out[mb + o] = m_r;
          m_out[mb + H + o] = m_u;
          m_out[mb + 2 * H + o] = m_xc;
          m_out[mb + 3 * H + o] = m_hc;
          h_out[(size_t)(b0 + bb) * H + o] = hn;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void act_grid_kernel(float* sig, float* tnh, int n, int lo_code,
                                Grid act, Grid lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __fdiv_rn((float)(lo_code + i), act.scale);  // exact
  sig[i] = lut_sigmoid(x, act, lut);
  tnh[i] = lut_tanh(x, act, lut);
}

template <int BITS>
int launch(const void* w_q, const void* scales, const void* b4,
           const void* m_prev, const void* h_prev, const void* dx,
           const void* dh, void* m_out, void* h_out, int B, int I, int H,
           int Hp, int K, int ip, int block_k, Grid act, Grid lut,
           cudaStream_t stream) {
  int chunk = 0;
  size_t smem = 0;
  const cudaError_t err = delta_walk::size_launch(
      delta_q8_gru_kernel<BITS>, B, K, block_k, &chunk, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kWarps - 1) / kWarps);
  delta_q8_gru_kernel<BITS><<<grid, kWarps * 32, smem, stream>>>(
      (const int8_t*)w_q, (const float*)scales, (const float*)b4,
      (const float*)m_prev, (const float*)h_prev, (const float*)dx,
      (const float*)dh, (float*)m_out, (float*)h_out, B, I, H, Hp, K, ip,
      block_k, chunk, act, lut);
  return (int)cudaGetLastError();
}

}  // namespace

// One int8 (weight_bits 8) or int4 (weight_bits 4) fused GRU layer step.
//   w_q int8 [3, Hp, K] or [3, Hp, K/2] (nibble-packed), scales f32 [3, Hp],
//   b4 f32 [4, Hp], m_prev/m_out f32 [B, 4H] (code domain), h_prev/h_out f32
//   [B, H], dx f32 [B, I], dh f32 [B, H]; contiguous, 16-byte aligned.
// Requires block_k % 4 == 0 and K % block_k == 0. Returns cudaGetLastError().
extern "C" int delta_q8_gru_step(
    const void* w_q, const void* scales, const void* b4, const void* m_prev,
    const void* h_prev, const void* dx, const void* dh, void* m_out,
    void* h_out, int B, int I, int H, int Hp, int K, int ip, int block_k,
    int weight_bits, float act_scale, float act_min, float act_max,
    float lut_scale, float lut_min, float lut_max, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (block_k % 4 || K % block_k || ip % block_k)
    return (int)cudaErrorInvalidValue;
  const Grid act{act_scale, act_min, act_max};
  const Grid lut{lut_scale, lut_min, lut_max};
  if (weight_bits == 8)
    return launch<8>(w_q, scales, b4, m_prev, h_prev, dx, dh, m_out, h_out, B,
                     I, H, Hp, K, ip, block_k, act, lut, (cudaStream_t)stream);
  if (weight_bits == 4)
    return launch<4>(w_q, scales, b4, m_prev, h_prev, dx, dh, m_out, h_out, B,
                     I, H, Hp, K, ip, block_k, act, lut, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// The kernel's own activation stage over every point of the activation grid:
// sig[i] = lut(sigmoid(x)), tnh[i] = lut(tanh(x)) for x = (lo_code + i) /
// act_scale, i < n. Used to check the device's expf / tanhf exhaustively
// against the host's after the LUT rounding.
extern "C" int delta_q8_act_grid(void* sig, void* tnh, int n, int lo_code,
                                 float act_scale, float act_min,
                                 float act_max, float lut_scale,
                                 float lut_min, float lut_max, void* stream) {
  const Grid act{act_scale, act_min, act_max};
  const Grid lut{lut_scale, lut_min, lut_max};
  act_grid_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)sig, (float*)tnh, n, lo_code, act, lut);
  return (int)cudaGetLastError();
}
