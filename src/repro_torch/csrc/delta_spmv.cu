// Block-column-skipping delta matvec for Hopper (sm_90a):
//   out[b, o] = acc[b, o] + sum_k dx[b, k] * w[o, k]
// reading only the block_k-wide column blocks of w in which some stream of
// dx fired.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/delta_spmv.py::_kernel
// (pallas_call in delta_spmv). The TPU version prefetches the compacted
// fired block ids as scalars, walks the grid (o-block, k-step) in order and
// carries the sum across k in its output block; the accumulator is fp32.
//
// What bounds it on this card: the weight bytes of the fired column blocks.
// At batch 1 a call does 2 operations per fetched 4-byte weight, far below
// the fp32 rate, so the bound is rows * fired columns * 4 bytes over memory
// bandwidth. Unlike the GRU/LSTM layer volumes, the LM projections do not
// stay in the 50 MB L2 across a step: one RWKV6 layer at D = 2048 is
// 50.9 MB of gated weights, one RG-LRU layer at W = 4096 is 268 MB, so this
// kernel streams from HBM at 3.35 TB/s.
//
// What the design does about it: one warp owns one output row and loops
// over the fired blocks itself (eight rows per thread block), so every
// block of rows streams its weights independently and 2048 rows give 256
// blocks for the 132 SMs. Each lane reads 16 bytes of the row per load
// (512 contiguous bytes per warp) where the row stride allows it, else 4.
// The prologue of csrc/delta_walk.cuh stages the deltas of up to kMaxB
// streams in shared memory and compacts the fired block ids on the device:
// no host sync and no block that no stream fired is read. The ragged edge
// of an unpacked [O, I] weight (I not a multiple of block_k) is masked here;
// rows are never padded. Simple first: no TMA, no wgmma, no pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

using delta_walk::kMaxB;
constexpr int kRows = 8;  // output rows (warps) per thread block

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// w [>= O, ldw] row-major; dx [B, I]; acc [B, O] or null; out [B, O].
// kp = I rounded up to block_k. kVec4: ldw % 4 == 0 and w 16-byte aligned.
template <bool kVec4>
__global__ void __launch_bounds__(kRows * 32) delta_spmv_kernel(
    const float* __restrict__ w, const float* __restrict__ dx,
    const float* __restrict__ acc, float* __restrict__ out, int B, int I,
    int O, int ldw, int kp, int block_k, int chunk) {
  extern __shared__ float4 smem4[];
  float* d_s = reinterpret_cast<float*>(smem4);           // [chunk][kp]
  int* fired = reinterpret_cast<int*>(d_s + chunk * kp);  // [kp / block_k]
  int* ids = fired + kp / block_k;                        // [kp / block_k]
  __shared__ int n_active;

  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kRows + (threadIdx.x >> 5);
  const float* w_o = w + (size_t)o * ldw;

  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int bc = min(chunk, B - b0);
    // one operand: every column is an "x" column (ip = K = kp, H = 0)
    delta_walk::stage_fired_blocks(dx, nullptr, d_s, fired, ids, &n_active,
                                   b0, bc, I, 0, kp, kp, block_k);
    if (o < O) {
      float a[kMaxB];
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) a[bb] = 0.0f;
#pragma unroll 4
      for (int j = 0; j < n_active; ++j) {
        const int kb0 = ids[j] * block_k;
        if (kVec4) {
          for (int c = lane * 4; c < block_k; c += 128) {
            const int k = kb0 + c;
            if (k < ldw) {  // ldw % 4 == 0, so k + 3 < ldw too
              const float4 wv = __ldg(reinterpret_cast<const float4*>(w_o + k));
#pragma unroll
              for (int bb = 0; bb < kMaxB; ++bb)
                if (bb < bc)
                  a[bb] += dot4(
                      *reinterpret_cast<const float4*>(d_s + bb * kp + k), wv);
            }
          }
        } else {
          for (int c = lane; c < block_k; c += 32) {
            const int k = kb0 + c;
            if (k < I) {  // the ragged edge of an unpacked row
              const float wv = __ldg(w_o + k);
#pragma unroll
              for (int bb = 0; bb < kMaxB; ++bb)
                if (bb < bc) a[bb] += d_s[bb * kp + k] * wv;
            }
          }
        }
      }
      delta_walk::warp_sum(a);
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb == lane && bb < bc) {
          const size_t idx = (size_t)(b0 + bb) * O + o;
          out[idx] = (acc != nullptr ? acc[idx] : 0.0f) + a[bb];
        }
      }
    }
    __syncthreads();  // the next pass overwrites the staged deltas
  }
}

template <bool kVec4>
cudaError_t launch(const float* w, const float* dx, const float* acc,
                   float* out, int B, int I, int O, int ldw, int kp,
                   int block_k, cudaStream_t stream) {
  int chunk = 0;
  size_t smem = 0;
  const cudaError_t err = delta_walk::size_launch(
      delta_spmv_kernel<kVec4>, B, kp, block_k, &chunk, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((O + kRows - 1) / kRows);
  delta_spmv_kernel<kVec4><<<grid, kRows * 32, smem, stream>>>(
      w, dx, acc, out, B, I, O, ldw, kp, block_k, chunk);
  return cudaGetLastError();
}

}  // namespace

// out [B, O] = acc [B, O] (or 0 when acc is null) + dx [B, I] @ w[:O, :I].T
// w: row-major with row stride ldw >= I and at least O rows (the packed
// layout: ldw = I rounded up to block_k; an unpacked [O, I] matrix: ldw = I).
// All fp32, contiguous. Requires block_k % 4 == 0. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int delta_spmv_f32(const void* w, const void* dx, const void* acc,
                              void* out, int B, int I, int O, int ldw,
                              int block_k, void* stream) {
  if (B <= 0 || O <= 0) return 0;
  if (I <= 0 || block_k <= 0 || block_k % 4 || ldw < I)
    return (int)cudaErrorInvalidValue;
  const int kp = (I + block_k - 1) / block_k * block_k;
  const bool vec4 = ldw % 4 == 0 && ((uintptr_t)w & 15) == 0;
  const cudaError_t err =
      vec4 ? launch<true>((const float*)w, (const float*)dx,
                          (const float*)acc, (float*)out, B, I, O, ldw, kp,
                          block_k, (cudaStream_t)stream)
           : launch<false>((const float*)w, (const float*)dx,
                           (const float*)acc, (float*)out, B, I, O, ldw, kp,
                           block_k, (cudaStream_t)stream);
  return (int)err;
}
