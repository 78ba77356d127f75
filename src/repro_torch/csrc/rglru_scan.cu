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
// traffic, and the design keeps the rest to one round trip.
//
// What the design does about it: a thread owns 4 adjacent channels of one
// stream (a work unit) and loads x, a and h0 with one 16-byte load each and
// stores y and h_T with one 16-byte store each, looping over the real T
// with the state in registers; at T > 1 the next step's x and a load while
// this step computes. Where W is not a multiple of 4 or an operand is not
// 16-byte aligned (VEC = false) the same thread takes 4-byte loads and
// stores, and the last unit of a row holds the ragged tail (its channels
// past W are neither read nor written). The host plan
// (kernels/rglru_scan.py::rglru_scan_plan) picks the threads a block (128:
// 8 blocks at B = 1, W = 4096), and the grid never exceeds the blocks the
// SMs hold at once: a block walks the units in turn. No channel or time
// padding. Every product and sum is rounded on its own (no fused
// multiply-add), as the plain version computes it, so the two agree to the
// bit on the card. h_T goes out with streaming stores (st.global.cs, evict-first in
// L2): its next reader is a later launch. The launch is a programmatic
// dependent launch: the grid may be scheduled while the kernel before it
// on the stream finishes, and waits for it (griddepcontrol.wait) before it
// reads anything.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;  // channels a thread owns

struct ScanArgs {
  const float *x, *a, *h0;
  float *y, *h_out;
  int T, W, row_units, units;
};

// load n <= 4 channels from p (the 16-byte path: n == 4, aligned)
template <bool VEC>
__device__ __forceinline__ void load4(const float* p, int n,
                                      float (&x)[kVec]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) x[c] = c < n ? p[c] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, int n,
                                       const float (&x)[kVec]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c < n) p[c] = x[c];
  }
}

// A store of the state, whose next reader is a later launch: past L1,
// evict-first in L2.
__device__ __forceinline__ void store_state(float4* p, float4 x) {
  __stcs(p, x);
}
__device__ __forceinline__ void store_state(float* p, float x) {
  __stcs(p, x);
}

template <bool VEC>
__device__ __forceinline__ void store_state4(float* p, int n,
                                             const float (&x)[kVec]) {
  if constexpr (VEC) {
    store_state(reinterpret_cast<float4*>(p),
                make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      if (c < n) store_state(p + c, x[c]);
  }
}

template <bool VEC>
__global__ void rglru_scan_kernel(const ScanArgs p) {
  // the kernels before this one on the stream are done and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int unit = blockIdx.x * blockDim.x + threadIdx.x; unit < p.units;
       unit += gridDim.x * blockDim.x) {
    const int b = unit / p.row_units;
    const int c0 = (unit - b * p.row_units) * kVec;
    const int n = min(kVec, p.W - c0);  // < 4 only in a ragged tail
    float h[kVec], x[kVec], a[kVec];
    if (p.h0 != nullptr) {
      load4<VEC>(p.h0 + (size_t)b * p.W + c0, n, h);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) h[c] = 0.0f;
    }
    const size_t base = (size_t)b * p.T * p.W + c0;
    if (p.T > 0) {
      load4<VEC>(p.x + base, n, x);
      load4<VEC>(p.a + base, n, a);
    }
    for (int t = 0; t < p.T; ++t) {
      const size_t off = base + (size_t)t * p.W;
      float xn[kVec] = {}, an[kVec] = {};
      if (t + 1 < p.T) {
        load4<VEC>(p.x + off + p.W, n, xn);
        load4<VEC>(p.a + off + p.W, n, an);
      }
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float norm =
            sqrtf(fmaxf(__fsub_rn(1.0f, __fmul_rn(a[c], a[c])), 0.0f));
        h[c] = __fadd_rn(__fmul_rn(a[c], h[c]), __fmul_rn(norm, x[c]));
      }
      store4<VEC>(p.y + off, n, h);
#pragma unroll
      for (int c = 0; c < kVec; ++c) x[c] = xn[c], a[c] = an[c];
    }
    store_state4<VEC>(p.h_out + (size_t)b * p.W + c0, n, h);
  }
}

__global__ void empty_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch kernel(args...) as a programmatic dependent launch.
template <typename... Args>
cudaError_t launch_pdl(void (*kernel)(Args...), int grid, int threads,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// x, a, y [B, T, W]; h0 (may be null: a zero state), h_out [B, W]; all
// fp32, contiguous. The plan (kernels/rglru_scan.py::rglru_scan_plan): vec
// (4: 16-byte loads, which needs W % 4 == 0 and every pointer 16-byte
// aligned; 1: 4-byte loads), threads a block (32, 64, 128 or 256) and grid
// (blocks, at most enough for one unit a thread: the threads walk the
// B * ceil(W / 4) units in turn). A plan the kernel cannot run returns
// cudaErrorInvalidValue. Launches on `stream` (a programmatic dependent
// launch) and returns cudaGetLastError() (0 on success).
extern "C" int rglru_scan_f32(const void* x, const void* a, const void* h0,
                              void* y, void* h_out, int B, int T, int W,
                              int vec, int threads, int grid, void* stream) {
  if (B < 0 || T < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  if (threads != 32 && threads != 64 && threads != 128 && threads != 256)
    return (int)cudaErrorInvalidValue;
  const int row_units = (W + kVec - 1) / kVec;
  const long long units = (long long)B * row_units;
  if (units > (1LL << 30) || grid < 1 ||
      grid > (units + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, a, h0, y, h_out};
  for (const void* p : ptrs)
    if (p != nullptr && ((uintptr_t)p & 3)) return (int)cudaErrorInvalidValue;
  if (vec == kVec) {
    if (W % kVec) return (int)cudaErrorInvalidValue;
    for (const void* p : ptrs)
      if (p != nullptr && ((uintptr_t)p & 15))
        return (int)cudaErrorInvalidValue;
  } else if (vec != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ScanArgs p{(const float*)x, (const float*)a, (const float*)h0,
                   (float*)y,       (float*)h_out,   T,
                   W,               row_units,       (int)units};
  const cudaError_t err = launch_pdl(
      vec == kVec ? rglru_scan_kernel<true> : rglru_scan_kernel<false>, grid,
      threads, (cudaStream_t)stream, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// An empty kernel of this build, launched as the scan is (a programmatic
// dependent launch) as blocks x threads: the floor under a launch of the
// scan at the same grid.
extern "C" int rglru_scan_empty(int blocks, int threads, void* stream) {
  const cudaError_t err =
      launch_pdl(empty_kernel, blocks, threads, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
