// WKV6 recurrence (RWKV-6 "Finch", data-dependent decay) for Hopper
// (sm_90a). Per (stream b, head h) and step t, with S [64 key, 64 value]:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Replaces: the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py::_kernel
// (pallas_call in rwkv6_scan). The TPU version keeps S in a VMEM scratch
// carried across sequential time-chunk grid steps and pads T to a chunk
// multiple with w = 1.
//
// What bounds it on this card: bytes. A step does about 5 operations per
// state element and reads and writes nothing but its 4 x 64 inputs and 64
// outputs; the state itself is read once (s0) and written once (S_T) per
// call. On the decode path T = 1, so moving S in and out (2 x 16 KB per
// head) is the whole cost: 1 MB for the 32 heads of one stream at
// D = 2048, 0.31 us at 3.35 TB/s.
//
// What the design does about it: one thread block of 64 threads per
// (b, h); thread j keeps the value column S[:, j] in 64 registers for the
// whole call, so the state moves once each way however long T is. Each step
// stages r, k and w (64 each) in shared memory, from where every thread
// reads the same element at the same time (a broadcast); v_j stays in a
// register and u is staged once. The loop runs over the real T inside the
// block: no chunking and no w = 1 padding.

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;  // RWKV6 head size

__global__ void __launch_bounds__(kD) rwkv6_scan_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out, int H, int T) {
  __shared__ float r_s[kD], k_s[kD], w_s[kD], u_s[kD];
  const int bh = blockIdx.x;  // b * H + h
  const int j = threadIdx.x;  // value column
  const size_t s_base = (size_t)bh * kD * kD;
  float s[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) s[i] = s0[s_base + i * kD + j];
  u_s[j] = u[(bh % H) * kD + j];
  const size_t base = (size_t)bh * T * kD;
  for (int t = 0; t < T; ++t) {
    const size_t off = base + (size_t)t * kD;
    __syncthreads();  // the previous step's reads of the staged rows are done
    r_s[j] = r[off + j];
    k_s[j] = k[off + j];
    w_s[j] = w[off + j];
    const float vj = v[off + j];
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const float kv = k_s[i] * vj;
      acc += r_s[i] * (s[i] + u_s[i] * kv);
      s[i] = w_s[i] * s[i] + kv;
    }
    y[off + j] = acc;
  }
#pragma unroll
  for (int i = 0; i < kD; ++i) s_out[s_base + i * kD + j] = s[i];
}

}  // namespace

// r, k, v, w, y [B, H, T, D]; u [H, D]; s0, s_out [B, H, D, D] (key-dim by
// value-dim); all fp32, contiguous. Requires D == 64. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, int B, int H, int T,
                              int D, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (D != kD || T < 0) return (int)cudaErrorInvalidValue;
  rwkv6_scan_kernel<<<B * H, kD, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, H, T);
  return (int)cudaGetLastError();
}
