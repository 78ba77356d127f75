// RG-LRU diagonal recurrence (RecurrentGemma / Griffin) for Hopper
// (sm_90a): per stream b and channel c,
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t
//
// Replaces: the Pallas TPU kernel src/repro/kernels/rglru_scan.py::_kernel
// (pallas_call in rglru_scan). The TPU version tiles the channels in
// 128-lane blocks, carries the [1, block_d] state in VMEM across sequential
// time chunks, and pads channels and time (a = 1 on time padding).
//
// What bounds it on this card: bytes. A step is five operations and one
// square root per channel against 12 bytes read (x, a) and written (y);
// h0 is read and h_T written once. On the decode path T = 1 and W = 4096:
// 80 KB per stream, 0.024 us at 3.35 TB/s, so a launch costs more than its
// traffic.
//
// What the design does about it: one thread per (b, c), looping over the
// real T with the state in a register; neighbouring threads read
// neighbouring channels. No channel or time padding. Every product and sum
// is rounded on its own (no fused multiply-add), as the plain version
// computes it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ h_out, int B, int T, int W) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;  // b * W + c
  if (idx >= B * W) return;
  const int b = idx / W;
  const int c = idx - b * W;
  float h = h0[idx];
  const size_t base = (size_t)b * T * W + c;
  for (int t = 0; t < T; ++t) {
    const size_t off = base + (size_t)t * W;
    const float at = a[off];
    const float norm = sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(at, at)), 0.0f));
    h = __fadd_rn(__fmul_rn(at, h), __fmul_rn(norm, x[off]));
    y[off] = h;
  }
  h_out[idx] = h;
}

}  // namespace

// x, a, y [B, T, W]; h0, h_out [B, W]; all fp32, contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_f32(const void* x, const void* a, const void* h0,
                              void* y, void* h_out, int B, int T, int W,
                              void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (T < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B * W + kThreads - 1) / kThreads;
  rglru_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)h0, (float*)y,
      (float*)h_out, B, T, W);
  return (int)cudaGetLastError();
}
