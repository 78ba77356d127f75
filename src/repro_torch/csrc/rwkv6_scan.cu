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
// Two designs, picked by the host plan from T
// (kernels/rwkv6_scan.py::rwkv6_scan_plan): the one-step kernel at T <= 1
// (the decode path and the delta engines), the chunked kernel at T > 1
// (a prefill).
//
// The one-step kernel (rwkv6_scan_kernel; chunk = 0 in the plan).
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
//   the host plan gives a grid of resident blocks that walk the units in
//   turn. The launch bounds ask for a full SM (2048 threads, 32
//   registers).
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
// - bf16 operands: a bf16 value is the upper half of its fp32, so a
//   thread's 4 v columns are one 8-byte load widened by shifts; r_i and
//   k_i are 2-byte loads.
// At T > 1 this design waits on device memory every step (only the next
// step's operands are in flight) and ends every step at a block barrier:
// 0.84 us a step at the LM prefill's [4, 32, 128, 64] in bf16.
//
// The chunked kernel (rwkv6_chunk_kernel; 1 <= chunk <= kChunk).
// What bounds it on this card: operations. A step does 7 fp32 operations
// per state element (3 fused multiply-adds and the k v product), 0.47
// GFLOP at [4, 32, 128, 64], 7.0 us at 67 TFLOP/s, against 4.4 us of
// bytes; the k v product's widening in bf16, the key sum's shuffles and
// the operand loads are instructions on top.
//
// What the design does about it:
// - No memory round trip in a step: a block stages `chunk` steps of r, k
//   and w for all 64 keys and of v for its columns in shared memory with
//   16-byte cp.async copies (element copies where an operand is not
//   16-byte aligned: VEC = false), into two buffers: chunk c + 1 arrives
//   while chunk c runs. A step reads only shared memory (ld.shared at
//   shared-window addresses, never the generic path) and registers, and
//   loads the next step's operands before it computes (the last step's
//   from a spare row: no branch in the loop).
// - No block barrier in a step: a thread owns 4 keys (4l .. 4l + 3) of 4
//   adjacent columns, so the 16 lanes l = 0 .. 15 of a half-warp hold all
//   64 keys of those columns and a warp 8 columns; the key sum is the
//   thread's 4 keys in order, then a reduce-scatter over the 16 lanes in a
//   fixed tree (xor 8, 4, 2, 1: 5 shuffles), and each 4 lanes end with one
//   column's sum. The one barrier is a chunk's, where its buffer turns
//   over. A unit is (b, h, `cols` columns), a warp per 8 columns: 8 warps
//   at 64 columns, two a scheduler, one of which works while the other
//   waits on a dependency (with 8 keys a thread a scheduler has one warp
//   and stalls on it).
// - Step t's key sum runs beside step t + 1's products (software
//   pipelined, 4 steps a trip): a sum waits on shuffles, the next step's
//   work on nothing of it.
// - The model's layout in place: r, k, v, w and y may lie in memory as
//   [B, T, H, D] (tmajor; the rows of a head's steps H * 64 elements
//   apart), so a prefill copies nothing into [B, H, T, D] and back.
// - y goes out as it is made: the 4 lanes that hold a column's sum store
//   it together (equal values, one 32-byte row of 8 columns a warp a step:
//   no branch), and nothing is left to flush at a chunk's end.
// - bf16: k_i v_j, k_i v_(j+1) are one bf16x2 product (fma.rn.bf16x2 with
//   -0: the exact product rounded once, as the reference's bf16 outer
//   product), widened by a shift and a mask.
// - A chunk's two buffers hold up to 66 KB (fp32, kChunk = 32 steps and a
//   spare row, 64 columns): above the default 48 KB, so
//   rwkv6_scan_prepare raises the limit once a device, at the first
//   launch of either kernel outside a capture.
// tools/scan_times.py --breakdown times it against the one-step kernel on
// the same operands, at other columns a block and other chunk lengths.
//
// Both designs: the loop runs over the real T (no w = 1 padding); s0 may be
// null (a zero state, nothing read); the launch is a programmatic
// dependent launch (the grid may be scheduled while the kernel before it
// on the stream finishes, and waits for it, griddepcontrol.wait, before it
// reads anything); the key sums run in a fixed order, so two launches on
// the same inputs give the same bits.

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
// the chunked kernel
constexpr int kKeys = 4;         // keys a thread owns
constexpr int kKeyLanes = kD / kKeys;  // lanes that share a column vector
constexpr int kWarpCols = 32 / kKeyLanes * kVec;  // value columns of a warp
constexpr int kChunk = 32;       // the most steps a chunk stages
constexpr int kChunkMaxThreads = kD / kWarpCols * 32;  // 64 columns a block
constexpr int kChunkBlocksPerSM = 2;  // the plan's residency: <= 128 registers

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

// -- the chunked kernel (T > 1) ---------------------------------------------

// The bytes of shared memory a block of the chunked kernel takes: two
// buffers, each `chunk` + 1 rows of w (fp32) and r, k (64 keys) and v
// (`cols` columns) in their type. A chunk fills `chunk` rows; the last
// step's read of the next step's operands lands in the spare row.
__host__ __device__ constexpr size_t chunk_smem(int chunk, int cols,
                                                size_t ti_bytes) {
  return 2 * (size_t)(chunk + 1) *
         (kD * sizeof(float) + (2 * kD + cols) * ti_bytes);
}

// The bytes of a staged row of 64 keys of type T one thread reads: its
// kKeys keys, one 16-byte (fp32) or 8-byte (bf16) piece.
template <typename T>
constexpr int kLaneBytes = kKeys * (int)sizeof(T);

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copy `n` rows of `cols` elements, `rs` elements apart in memory, into a
// staged array of rows of `cols`: 16-byte copies in flight (VEC), else
// element by element.
template <bool VEC, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int n,
                                           int cols, int rs) {
  if constexpr (VEC) {
    constexpr int E = 16 / sizeof(T);
    const int P = cols / E;
    for (int q = threadIdx.x; q < n * P; q += blockDim.x) {
      const int t = q / P, j = (q % P) * E;
      cp_async16(dst + t * cols + j, src + (size_t)t * rs + j);
    }
  } else {
    for (int e = threadIdx.x; e < n * cols; e += blockDim.x)
      dst[e] = src[(size_t)(e / cols) * rs + e % cols];
  }
}

// One buffer of staged steps: w, r, k rows of 64 keys, v rows of `cols`.
template <typename TI>
struct Staged {
  float* w;
  TI *r, *k, *v;
};

// Buffer `buf` (0 or 1) of a block's shared memory, computed from the
// shared array itself (the compiler then knows every access is shared).
template <typename TI>
__device__ __forceinline__ Staged<TI> staged(unsigned char* smem, int buf,
                                             int chunk, int cols) {
  unsigned char* p = smem + buf * chunk_smem(chunk, cols, sizeof(TI)) / 2;
  Staged<TI> b;
  b.w = reinterpret_cast<float*>(p);
  b.r = reinterpret_cast<TI*>(b.w + (chunk + 1) * kD);
  b.k = b.r + (chunk + 1) * kD;
  b.v = b.k + (chunk + 1) * kD;
  return b;
}

// Shared-memory loads at a shared-window address (ld.shared: the step's
// operands never take the generic path).
__device__ __forceinline__ uint4 lds128(unsigned at) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at));
  return v;
}

__device__ __forceinline__ uint2 lds64(unsigned at) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(at));
  return v;
}

// Raw 32-bit words read from shared memory.
template <int N>
struct Words {
  unsigned x[N];
};

// A thread's keys of a staged row of type T at shared address `row`:
// kLaneBytes<T> bytes.
template <typename T>
__device__ __forceinline__ Words<kLaneBytes<T> / 4> read_keys(unsigned row,
                                                              int l) {
  constexpr int B = kLaneBytes<T>;
  Words<B / 4> o;
  if constexpr (B == 16) {
    const uint4 a = lds128(row + 16 * l);
    o = {{a.x, a.y, a.z, a.w}};
  } else {
    const uint2 a = lds64(row + 8 * l);
    o = {{a.x, a.y}};
  }
  return o;
}

// A thread's 4 value columns of type T at shared address `at`.
template <typename T>
__device__ __forceinline__ Words<kVec * sizeof(T) / 4> read_cols(unsigned at) {
  Words<kVec * sizeof(T) / 4> o;
  if constexpr (sizeof(T) == 4) {
    const uint4 a = lds128(at);
    o = {{a.x, a.y, a.z, a.w}};
  } else {
    const uint2 a = lds64(at);
    o = {{a.x, a.y}};
  }
  return o;
}

// A step's operands as a thread reads them from shared memory: its keys
// of r, k, w and its 4 columns of v, as raw words.
template <typename TI>
struct StepIn {
  Words<kLaneBytes<TI> / 4> r, k;
  Words<kLaneBytes<float> / 4> w;
  Words<kVec * sizeof(TI) / 4> v;
};

// The shared addresses of a buffer's rows of step 0 (a thread's v
// columns included) and the bytes from one step's rows to the next.
struct Rows {
  unsigned w, r, k, v;
  int w_step, rk_step, v_step;
};

template <typename TI>
__device__ __forceinline__ StepIn<TI> read_step(const Rows& a, int t, int l) {
  return {read_keys<TI>(a.r + t * a.rk_step, l),
          read_keys<TI>(a.k + t * a.rk_step, l),
          read_keys<float>(a.w + t * a.w_step, l),
          read_cols<TI>(a.v + t * a.v_step)};
}

// k_i v_j and k_i v_(j+1) of bf16 operands (k2: k_i in both halves, v2:
// v_j, v_(j+1)): one bf16x2 product, the exact product rounded once to
// bf16 (round to nearest even), as the reference's bf16 outer product.
__device__ __forceinline__ void kv_bf16(unsigned k2, unsigned v2, float& lo,
                                        float& hi) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(k2), "r"(v2), "r"(0x80008000u));
  lo = __uint_as_float(d << 16);
  hi = __uint_as_float(d & 0xffff0000u);
}

// The step's r, w and k v products, widened to fp32.
__device__ __forceinline__ void unpack(const StepIn<float>& x,
                                       float (&r)[kKeys], float (&w)[kKeys],
                                       float (&kv)[kKeys][kVec]) {
#pragma unroll
  for (int m = 0; m < kKeys; ++m) {
    r[m] = __uint_as_float(x.r.x[m]);
    w[m] = __uint_as_float(x.w.x[m]);
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      kv[m][c] = __uint_as_float(x.k.x[m]) * __uint_as_float(x.v.x[c]);
  }
}

__device__ __forceinline__ void unpack(const StepIn<__nv_bfloat16>& x,
                                       float (&r)[kKeys], float (&w)[kKeys],
                                       float (&kv)[kKeys][kVec]) {
#pragma unroll
  for (int m = 0; m < kKeys / 2; ++m) {
    r[2 * m] = __uint_as_float(x.r.x[m] << 16);
    r[2 * m + 1] = __uint_as_float(x.r.x[m] & 0xffff0000u);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const unsigned k2 = __byte_perm(x.k.x[m], 0, half ? 0x3232 : 0x1010);
      float(&o)[kVec] = kv[2 * m + half];
      kv_bf16(k2, x.v.x[0], o[0], o[1]);
      kv_bf16(k2, x.v.x[1], o[2], o[3]);
    }
  }
#pragma unroll
  for (int m = 0; m < kKeys; ++m) w[m] = __uint_as_float(x.w.x[m]);
}

// One step of a thread's keys and columns: the state update in place and
// acc[q], the sum over its keys (in key order) of r_i (S_iq + u_i kv_iq).
template <typename TI>
__device__ __forceinline__ void step_keys(const StepIn<TI>& x,
                                          const float (&u)[kKeys],
                                          float (&s)[kKeys][kVec],
                                          float (&acc)[kVec]) {
  float r[kKeys], w[kKeys], kv[kKeys][kVec];
  unpack(x, r, w, kv);
#pragma unroll
  for (int m = 0; m < kKeys; ++m) {
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const float mq = fmaf(u[m], kv[m][q], s[m][q]);
      acc[q] = m == 0 ? r[m] * mq : fmaf(r[m], mq, acc[q]);
      s[m][q] = fmaf(w[m], s[m][q], kv[m][q]);
    }
  }
}

// The sum over the L = kKeyLanes lanes' keys of a column vector, a
// reduce-scatter in a fixed tree: halves of the 4 columns across xor L / 2,
// then xor L / 4, then the L / 4 lanes that hold one column add the same
// terms in mirrored order (addition commutes: equal bits) and all store
// it at y, their column's row of the step (one store of equal values: no
// branch in the step).
__device__ __forceinline__ void sum_keys(const float (&acc)[kVec], bool hi,
                                         bool mid, float* y) {
  constexpr int L = kKeyLanes;
  float k0 = hi ? acc[2] : acc[0], k1 = hi ? acc[3] : acc[1];
  const float o0 = hi ? acc[0] : acc[2], o1 = hi ? acc[1] : acc[3];
  k0 += __shfl_xor_sync(kFull, o0, L / 2);
  k1 += __shfl_xor_sync(kFull, o1, L / 2);
  float sum = mid ? k1 : k0;
  sum += __shfl_xor_sync(kFull, mid ? k0 : k1, L / 4);
#pragma unroll
  for (int off = L / 8; off > 0; off >>= 1)
    sum += __shfl_xor_sync(kFull, sum, off);
  *y = sum;
}

template <typename TI, bool VEC>
__global__ void __launch_bounds__(kChunkMaxThreads, kChunkBlocksPerSM)
    rwkv6_chunk_kernel(const ScanArgs<TI> a, int cols, int chunk,
                       bool tmajor) {
  constexpr int L = kKeyLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, l = lane % L;
  // this thread's first column in its unit; the L lanes of a column
  // vector are adjacent
  const int j = (threadIdx.x >> 5) * kWarpCols + (lane / L) * kVec;
  const int groups = kD / cols;
  // the reduce-scatter's halves: after it lanes l .. l + L / 4 - 1 hold
  // column j + 2 * hi + mid
  const bool hi = l & (L / 2), mid = l & (L / 4);
  const int y_col = j + (hi ? 2 : 0) + (mid ? 1 : 0);
  const int nchunks = (a.T + chunk - 1) / chunk;
  // the kernels before this one on the stream are done and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");

  for (int unit = blockIdx.x; unit < a.units; unit += gridDim.x) {
    const int bh = unit / groups;      // b * H + h
    const int c0 = (unit % groups) * cols;
    // the head's step 0 and the elements from one step to the next of r,
    // k, v, w and y: [B, H, T, D] or, time-major, [B, T, H, D]
    const size_t base =
        tmajor ? ((size_t)(bh / a.H) * a.T * a.H + bh % a.H) * kD
               : (size_t)bh * a.T * kD;
    const int rs = tmajor ? a.H * kD : kD;
    auto stage = [&](int c) {          // chunk c into buffer c & 1
      const Staged<TI> b = staged<TI>(smem, c & 1, chunk, cols);
      const size_t at = base + (size_t)c * chunk * rs;
      const int n = min(chunk, a.T - c * chunk);
      stage_rows<VEC>(b.w, a.w + at, n, kD, rs);
      stage_rows<VEC>(b.r, a.r + at, n, kD, rs);
      stage_rows<VEC>(b.k, a.k + at, n, kD, rs);
      stage_rows<VEC>(b.v, a.v + at + c0, n, cols, rs);
      if constexpr (VEC) asm volatile("cp.async.commit_group;" ::: "memory");
    };
    if (nchunks > 0) stage(0);
    float s[kKeys][kVec], u[kKeys];
    const size_t s_at = (size_t)bh * kD * kD + (size_t)kKeys * l * kD + c0 + j;
#pragma unroll
    for (int m = 0; m < kKeys; ++m) {
      u[m] = a.u[(bh % a.H) * kD + kKeys * l + m];
      if (a.s0 != nullptr) {
        load4<VEC>(a.s0 + s_at + (size_t)m * kD, s[m]);
      } else {
#pragma unroll
        for (int c = 0; c < kVec; ++c) s[m][c] = 0.0f;
      }
    }
    for (int c = 0; c < nchunks; ++c) {
      if constexpr (VEC) asm volatile("cp.async.wait_all;" ::: "memory");
      // chunk c is in buffer c & 1 for every thread, and every thread is
      // done with chunk c - 1, whose buffer chunk c + 1 now takes
      __syncthreads();
      if (c + 1 < nchunks) stage(c + 1);
      const Staged<TI> b = staged<TI>(smem, c & 1, chunk, cols);
      const Rows rows{(unsigned)__cvta_generic_to_shared(b.w),
                      (unsigned)__cvta_generic_to_shared(b.r),
                      (unsigned)__cvta_generic_to_shared(b.k),
                      (unsigned)__cvta_generic_to_shared(b.v + j),
                      kD * (int)sizeof(float), kD * (int)sizeof(TI),
                      cols * (int)sizeof(TI)};
      const int n = min(chunk, a.T - c * chunk);
      float* y = a.y + base + (size_t)c * chunk * rs + c0 + y_col;
      // step t's key sum runs beside step t + 1's products: a step's sum
      // waits on shuffles, the next step's work on nothing of it; the next
      // step's operands load while this one computes (the last step's
      // from the spare row: no branch in the loop)
      float acc[kVec], prev[kVec];
      StepIn<TI> x = read_step<TI>(rows, 0, l);
      StepIn<TI> nx = read_step<TI>(rows, 1, l);
      step_keys(x, u, s, prev);
      x = nx;
#pragma unroll 4
      for (int t = 1; t < n; ++t) {
        nx = read_step<TI>(rows, t + 1, l);
        step_keys(x, u, s, acc);
        sum_keys(prev, hi, mid, y + (size_t)(t - 1) * rs);
#pragma unroll
        for (int q = 0; q < kVec; ++q) prev[q] = acc[q];
        x = nx;
      }
      sum_keys(prev, hi, mid, y + (size_t)(n - 1) * rs);
    }
#pragma unroll
    for (int m = 0; m < kKeys; ++m)
      store_state4<VEC>(a.s_out + s_at + (size_t)m * kD, s[m]);
    // the next unit stages into buffer 0 again: every thread must be done
    // with this unit's chunks
    if (unit + gridDim.x < a.units) __syncthreads();
  }
}

__global__ void empty_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch kernel(args...) as a programmatic dependent launch.
template <typename... Args>
cudaError_t launch_pdl(void (*kernel)(Args...), int grid, int threads,
                       size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The checks and launch of either instance (TI: the type of r, k, v).
template <typename TI>
int launch_scan(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int B,
                int H, int T, int D, int cols, int chunk, int tmajor,
                int vec, int grid, void* stream) {
  if (B < 0 || H < 0 || D != kD || T < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (vec != kVec && vec != 1) return (int)cudaErrorInvalidValue;
  const bool chunked = chunk != 0;
  if (chunked ? (chunk < 1 || chunk > kChunk ||
                 (cols != 16 && cols != 32 && cols != 64))
              : (cols != kCols || T > 1))
    return (int)cudaErrorInvalidValue;
  if (tmajor != 0 && (tmajor != 1 || !chunked))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * H * (kD / cols);
  if (units > (1LL << 30) || grid < 1 || grid > units)
    return (int)cudaErrorInvalidValue;
  // the one-step kernel's loads of 4 columns: 16 bytes of fp32, 8 of bf16
  // (vec = 4); the chunked kernel's copies: 16 bytes of every operand
  // (vec = 4); else one element at a time
  const uintptr_t in_mask =
      (vec == kVec ? (chunked ? 16 : kVec * sizeof(TI)) : sizeof(TI)) - 1;
  const uintptr_t f32_mask = (vec == kVec ? 16 : sizeof(float)) - 1;
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
  const cudaError_t err =
      chunked ? launch_pdl(vec == kVec ? rwkv6_chunk_kernel<TI, true>
                                       : rwkv6_chunk_kernel<TI, false>,
                           grid, cols / kWarpCols * 32,
                           chunk_smem(chunk, cols, sizeof(TI)),
                           (cudaStream_t)stream, a, cols, chunk,
                           tmajor != 0)
              : launch_pdl(vec == kVec ? rwkv6_scan_kernel<TI, true>
                                       : rwkv6_scan_kernel<TI, false>,
                           grid, kThreads, 0, (cudaStream_t)stream, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, y [B, H, T, D]; u [H, D]; s0 (may be null: a zero state),
// s_out [B, H, D, D] (key-dim by value-dim); contiguous; r, k, v fp32
// (rwkv6_scan_f32) or bf16 (rwkv6_scan_bf16), everything else fp32.
// tmajor = 1 (the chunked kernel only): r, k, v, w and y lie in memory as
// contiguous [B, T, H, D] (the model's layout; a [B, H, T, D] view of
// them is a transpose). Requires D == 64. The plan
// (kernels/rwkv6_scan.py::rwkv6_scan_plan):
// chunk (0: the one-step kernel, at T <= 1; 1 .. kChunk: the chunked
// kernel, `chunk` steps a stage, at any T), cols, the value columns a
// block handles (kCols for the one-step kernel; 16, 32 or 64 for the
// chunked one, whose block has 4 * cols threads), vec (4: 16-byte copies
// or vector loads, which every pointer must allow; 1: one element at a
// time) and grid
// (blocks, at most one per unit: the blocks walk the B * H * 64 / cols
// units in turn). The chunked kernel's shared memory above 48 KB needs
// rwkv6_scan_prepare on the device first. A plan the kernel cannot run
// returns cudaErrorInvalidValue. Launches on `stream` (a programmatic
// dependent launch) and returns cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_f32(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, int B, int H, int T,
                              int D, int cols, int chunk, int tmajor,
                              int vec, int grid, void* stream) {
  return launch_scan<float>(r, k, v, w, u, s0, y, s_out, B, H, T, D, cols,
                            chunk, tmajor, vec, grid, stream);
}

extern "C" int rwkv6_scan_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, int B, int H, int T,
                               int D, int cols, int chunk, int tmajor,
                               int vec, int grid, void* stream) {
  return launch_scan<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, B, H, T, D,
                                    cols, chunk, tmajor, vec, grid, stream);
}

// Let every instance of the chunked kernel take the most shared memory a
// plan may give it (fp32, kChunk steps, 64 columns: 64 KB) on the current
// device. Once a device, before its first chunked launch above 48 KB; not
// inside a stream capture. Returns the CUDA error (0 on success).
extern "C" int rwkv6_scan_prepare() {
  const int bytes = (int)chunk_smem(kChunk, kD, sizeof(float));
  void (*kernels[])(const ScanArgs<float>, int, int, bool) = {
      rwkv6_chunk_kernel<float, true>, rwkv6_chunk_kernel<float, false>};
  void (*kernels16[])(const ScanArgs<__nv_bfloat16>, int, int, bool) = {
      rwkv6_chunk_kernel<__nv_bfloat16, true>,
      rwkv6_chunk_kernel<__nv_bfloat16, false>};
  for (auto kernel : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  for (auto kernel : kernels16) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// An empty kernel of this build, launched as the scan is (a programmatic
// dependent launch) as blocks x threads: the floor under a launch of the
// scan at the same grid.
extern "C" int rwkv6_scan_empty(int blocks, int threads, void* stream) {
  const cudaError_t err =
      launch_pdl(empty_kernel, blocks, threads, 0, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
