// WKV6 recurrence (RWKV-6 "Finch", data-dependent decay) for Hopper
// (sm_90a). Per (stream b, head h) and step t, with S [64 key, 64 value]:
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// Two instances: rwkv6_scan_f32 (every operand fp32) and rwkv6_scan_bf16
// (r, k, v in bf16; w, u, the state and y fp32, as the bf16 models give
// them). The bf16 instance rounds k_t[i] * v_t[j] to bf16 (round to
// nearest even) before it is used, as the reference's bf16 x bf16 outer
// product does (src/repro/kernels/ref.py::rwkv6_scan_ref); u times that,
// the state update and the sum over keys stay fp32, as the reference
// promotes them.
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
// D = 2048, 0.31 us at 3.35 TB/s. So a call is a launch and one round trip
// to memory, and the design spreads that round trip over the card.
//
// What the design does about it:
// - y_t[j] and S[:, j] depend on value column j alone, so a head's 64
//   columns split over 64 / kCols blocks with no reduction between
//   blocks: a work unit is (b, h, a group of kCols = 16 columns; 128 blocks
//   at B = 1, H = 32: of 16, 32 and 64 columns the fastest at B = 1), and
//   the host plan (kernels/rwkv6_scan.py::rwkv6_scan_plan) gives a grid of
//   resident blocks that walk the units in turn. The launch bounds ask for
//   a full SM (2048 threads, 32 registers).
// - A block has one thread per (key i, 4 adjacent columns): 256
//   threads. Thread (i, q) keeps S[i][4q .. 4q + 3] in registers for the
//   whole call and moves it with one 16-byte load and one 16-byte store
//   (4-byte loads where an operand is not 16-byte aligned: VEC = false).
// - One round trip: every operand of a step (the S vector, r_i, k_i, w_i,
//   u_i, the v vector) is loaded before any barrier; at T > 1 the next
//   step's operands are loaded while this step reduces.
// - The sum over the 64 keys runs in a fixed order: a shuffle tree over
//   the keys of a warp, then the warps' partial sums through shared memory,
//   added in warp order behind the step's one barrier (two buffers of
//   partials alternate by step). Two launches on the same inputs give the
//   same bits.
// - The state goes out with streaming stores (st.global.cs, evict-first in
//   L2): its next reader is a later launch. With write-back stores of the
//   same layout the kernel took 1.96 us at B = 1 and 5.90 at B = 8 where
//   it takes 1.64 and 3.21 (H100 80GB HBM3, 700 W; tools/scan_times.py
//   --breakdown times both builds).
// - The launch is a programmatic dependent launch: the grid may be
//   scheduled while the kernel before it on the stream finishes, and waits
//   for it (griddepcontrol.wait) before it reads anything.
// - The loop runs over the real T inside the block: no chunking and no
//   w = 1 padding. s0 may be null (a zero state, nothing read).
// - bf16 operands: a bf16 value is the upper half of its fp32, so a
//   thread's 4 v columns are one 8-byte load widened by shifts; r_i and
//   k_i are 2-byte loads. The bf16 instance is the fp32 one with half the
//   bytes of r, k and v; it is not tuned further.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;           // RWKV6 head size: keys and value columns
constexpr int kVec = 4;          // value columns a thread owns
constexpr int kCols = 16;        // value columns of a work unit
constexpr int kThreads = kD * kCols / kVec;  // one (key, column vector) each
constexpr int kThreadsPerSM = 2048;  // the plan's residency: 32 registers
constexpr unsigned kFull = 0xffffffffu;

// TI: the type of r, k and v (float or __nv_bfloat16)
template <typename TI>
struct ScanArgs {
  const TI *r, *k, *v;
  const float *w, *u, *s0;
  float *y, *s_out;
  int H, T, units;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// k_t[i] * v_t[j] as the reference forms it in the operands' type: exact
// in fp32 for fp32 operands' product, rounded to bf16 for bf16 operands
// (the fp32 product of two bf16 values is exact, so one rounding)
__device__ __forceinline__ float outer(float k, float v, float) {
  return k * v;
}
__device__ __forceinline__ float outer(float k, float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(k * v));
}

template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  if constexpr (VEC) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(q.x << 16);
    x[1] = __uint_as_float(q.x & 0xffff0000u);
    x[2] = __uint_as_float(q.y << 16);
    x[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) x[c] = __bfloat162float(p[c]);
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const float* p, float (&x)[kVec]) {
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) x[c] = p[c];
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
__device__ __forceinline__ void store_state4(float* p,
                                             const float (&x)[kVec]) {
  if constexpr (VEC) {
    store_state(reinterpret_cast<float4*>(p),
                make_float4(x[0], x[1], x[2], x[3]));
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) store_state(p + c, x[c]);
  }
}

template <typename TI, bool VEC>
__global__ void __launch_bounds__(kThreads, kThreadsPerSM / kThreads)
    rwkv6_scan_kernel(const ScanArgs<TI> a) {
  constexpr int Q = kCols / kVec;  // column vectors of a unit
  constexpr int NW = kD * Q / 32;  // warps of a block
  constexpr int GROUPS = kD / kCols;
  __shared__ float part[2][NW][kCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / Q, q = tid % Q;  // key, column vector
  // the kernels before this one on the stream are done and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");

  for (int unit = blockIdx.x; unit < a.units; unit += gridDim.x) {
    const int bh = unit / GROUPS;      // b * H + h
    const int c0 = (unit % GROUPS) * kCols;
    const int j = c0 + q * kVec;       // this thread's first column
    const size_t s_at = (size_t)bh * kD * kD + (size_t)i * kD + j;
    const size_t base = (size_t)bh * a.T * kD;
    // every operand of step 0 before anything waits
    float s[kVec], v[kVec];
    if (a.s0 != nullptr) {
      load4<VEC>(a.s0 + s_at, s);
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) s[c] = 0.0f;
    }
    const float ui = a.u[(bh % a.H) * kD + i];
    float ri = 0.0f, ki = 0.0f, wi = 0.0f;
    if (a.T > 0) {
      ri = to_f32(a.r[base + i]), ki = to_f32(a.k[base + i]);
      wi = a.w[base + i];
      load4<VEC>(a.v + base + j, v);
    }
    for (int t = 0; t < a.T; ++t) {
      // the next step's operands load while this one reduces
      const size_t nx = base + (size_t)(t + 1) * kD;
      float rn = 0.0f, kn = 0.0f, wn = 0.0f, vn[kVec] = {};
      if (t + 1 < a.T) {
        rn = to_f32(a.r[nx + i]), kn = to_f32(a.k[nx + i]);
        wn = a.w[nx + i];
        load4<VEC>(a.v + nx + j, vn);
      }
      float p[kVec];
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float kv = outer(ki, v[c], TI{});
        p[c] = ri * (s[c] + ui * kv);
        s[c] = wi * s[c] + kv;
      }
      // the sum over the keys: the warp's keys by a shuffle tree (lanes of
      // one column vector are Q apart), then the warps in order
#pragma unroll
      for (int off = Q; off < 32; off <<= 1) {
#pragma unroll
        for (int c = 0; c < kVec; ++c)
          p[c] += __shfl_xor_sync(kFull, p[c], off);
      }
      float* mine = part[t & 1][warp];
      if (lane < Q) {
#pragma unroll
        for (int c = 0; c < kVec; ++c) mine[lane * kVec + c] = p[c];
      }
      __syncthreads();  // the one barrier of a step
      if (tid < kCols) {
        float sum = 0.0f;
#pragma unroll
        for (int wq = 0; wq < NW; ++wq) sum += part[t & 1][wq][tid];
        a.y[base + (size_t)t * kD + c0 + tid] = sum;
      }
      ri = rn, ki = kn, wi = wn;
#pragma unroll
      for (int c = 0; c < kVec; ++c) v[c] = vn[c];
    }
    store_state4<VEC>(a.s_out + s_at, s);
    // the next unit's first step writes part[0] again: the readers of this
    // unit's last step must be done with it
    if (unit + gridDim.x < a.units) __syncthreads();
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

// The checks and launch of either instance (TI: the type of r, k, v).
template <typename TI>
int launch_scan(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int B,
                int H, int T, int D, int cols, int vec, int grid,
                void* stream) {
  if (B < 0 || H < 0 || D != kD || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (cols != kCols) return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * H * (kD / kCols);
  if (units > (1LL << 30) || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  // a thread's loads of 4 columns: 16 bytes of fp32, 8 of bf16 (vec = 4),
  // else one element at a time
  const uintptr_t in_mask = (vec == kVec ? kVec : 1) * sizeof(TI) - 1;
  const uintptr_t f32_mask = (vec == kVec ? kVec : 1) * sizeof(float) - 1;
  const void* ins[] = {r, k, v};
  const void* f32s[] = {w, u, s0, y, s_out};
  for (const void* p : ins)
    if ((uintptr_t)p & in_mask) return (int)cudaErrorInvalidValue;
  for (const void* p : f32s)
    if (p != nullptr && ((uintptr_t)p & f32_mask))
      return (int)cudaErrorInvalidValue;
  const ScanArgs<TI> a{(const TI*)r,     (const TI*)k,     (const TI*)v,
                       (const float*)w,  (const float*)u,  (const float*)s0,
                       (float*)y,        (float*)s_out,    H,
                       T,                (int)units};
  const cudaError_t err = launch_pdl(
      vec == kVec ? rwkv6_scan_kernel<TI, true> : rwkv6_scan_kernel<TI, false>,
      grid, kThreads, (cudaStream_t)stream, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y [B, H, T, D]; u [H, D]; s0 (may be null: a zero state),
// s_out [B, H, D, D] (key-dim by value-dim); contiguous; r, k, v fp32
// (rwkv6_scan_f32) or bf16 (rwkv6_scan_bf16), everything else fp32.
// Requires D == 64. The plan (kernels/rwkv6_scan.py::rwkv6_scan_plan):
// cols, the value columns a block handles (kCols), vec (4: vector loads of
// 4 columns, which every pointer must allow; 1: one element at a time) and
// grid (blocks, at most one per unit: the blocks walk the B * H * 64 / cols
// units in turn). A plan the kernel cannot run returns
// cudaErrorInvalidValue. Launches on `stream` (a programmatic dependent
// launch) and returns cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, int B, int H, int T,
                              int D, int cols, int vec, int grid,
                              void* stream) {
  return launch_scan<float>(r, k, v, w, u, s0, y, s_out, B, H, T, D, cols,
                            vec, grid, stream);
}

extern "C" int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, int B, int H, int T,
                               int D, int cols, int vec, int grid,
                               void* stream) {
  return launch_scan<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, T, D,
                                    cols, vec, grid, stream);
}

// An empty kernel of this build, launched as the scan is (a programmatic
// dependent launch) as blocks x threads: the floor under a launch of the
// scan at the same grid.
extern "C" int rwkv6_scan_empty(int blocks, int threads, void* stream) {
  const cudaError_t err =
      launch_pdl(empty_kernel, blocks, threads, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
