// The AdamW update of a whole parameter tree in one launch, for Hopper
// (sm_90a). For every element of every leaf, in the order of the plain
// version (fused_adam_ref in src/repro_torch/kernels/fused_adam.py):
//   g   = float(g) * scale                  (no multiply without clipping)
//   mu' = b1 * mu + (1 - b1) * g
//   nu' = b2 * nu + ((1 - b2) * g) * g
//   d   = (mu' / corr1) / (sqrt(nu' / corr2) + eps)   [+ wd * float(p)]
//   p'  = p - lr * d, rounded to the parameter's type (round half to even)
// p', mu' and nu' may alias p, mu and nu: each element is read before it
// is written, by the thread that writes it, so a compiled step updates its
// state buffers in place.
//
// Replaces no Pallas kernel: the JAX package's update is an XLA fusion
// inside its jitted train steps (src/repro/train/trainer.py:122 and :149,
// src/repro/launch/train.py:63). Before this kernel the port ran it as ~12
// PyTorch kernels a leaf, each writing a full-size fp32 temporary.
//
// What bounds it on this card: bytes. Each element reads p, g, mu and nu
// and writes p, mu and nu (22 bytes for a bf16 parameter and gradient, 28
// in fp32); llama3.2-1b's 1.236 G parameters move 27.2 GB, 8.1 ms at
// 3.35 TB/s. The design is about the memory system:
// * Vector accesses that fill whole 32-byte sectors: a warp takes a tile
//   of kTile consecutive elements, a lane kPieces pieces of 4 elements 128
//   apart, so each access instruction of the warp covers 128 consecutive
//   elements (a 16-byte access a lane of an fp32 operand, 8 bytes of a
//   bf16 one). The wrapper's plan (leaf_plan in kernels/fused_adam.py)
//   gives each leaf a scalar head of up to 7 elements after which all
//   seven operands start on 16 bytes, its whole pieces, and a scalar tail
//   of up to 3; a leaf whose operands cannot all be aligned at one
//   element is taken element by element in the same tiles.
// * Loads in flight: a lane loads all its pieces of a tile, 8 vector
//   accesses, into registers before it computes any.
// * Streaming hints (ld.global.cs, st.global.cs): nothing is read again,
//   and what streams through L2 marked evict-first leaves there the
//   gradients that the global norm has just read (in the compiled
//   2L-768H step the fp32 instance runs ~3 us under its time alone; with
//   plain loads and stores it gains nothing: tools/opt_variants.py).
// * Work handed out in one sweep of the grid over the tree, in tree order
//   (the order in which the global norm has just read the gradients, and
//   in which part of them still lies in L2): a leaf's chunks of kChunk
//   elements give it kChunk / kTile tile slots each, and warp w of block
//   b takes slot b kWarps + w and then every grid kWarps; a block finds
//   its first leaf by one binary search of the table and its warps walk
//   forward from there, reading a leaf's row once.
// Every multiply, add, divide and square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc would contract a
// multiply and an add into one fma, and the plain version's PyTorch
// kernels round each operation, so the result is bitwise theirs (R3).
// The scale, lr, corr1 and corr2 are 0-d device tensors that the step
// computes (the global norm, the schedule, 1 - b ** t): the kernel reads
// them from device memory, so nothing waits for the host and a graph stays
// valid from step to step. b1, 1 - b1, b2, 1 - b2, eps and wd come from
// the host, each rounded from a double as PyTorch rounds a scalar operand
// of a float32 op. The table (pointers, lengths, first chunks, the
// gradient's type, each leaf's plan) lives in device memory, written by
// the wrapper: a captured graph keeps the table's address and not its
// bytes, so the table is written once a capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 4;                     // elements a lane's access
constexpr int kTile = 256;                    // elements a warp's tile
constexpr int kPieces = kTile / (32 * kPiece);   // a lane's pieces a tile
constexpr long long kChunk = 8192;            // elements of a leaf a chunk
constexpr int kTilesPerChunk = kChunk / kTile;
constexpr int kBlocksPerSm = 2;               // resident blocks an SM

// one row of the leaf table: twelve 8-byte words, as the wrapper writes
struct Leaf {
  const void* p;
  const void* g;
  const float* mu;
  const float* nu;
  void* p_out;
  float* mu_out;
  float* nu_out;
  long long n;        // elements
  long long item0;    // the leaf's first chunk in the launch's numbering
  long long g_bf16;   // 1: the gradient is bf16, 0: fp32
  long long head;     // scalar elements before the first tile
  long long vec;      // 1: whole pieces take vector accesses
};
static_assert(sizeof(Leaf) == 96, "the wrapper writes twelve words a leaf");

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
  int decay;
};

struct Step {
  Consts c;
  bool clip;
  float s, lr, c1, c2;
  bool c1_pos, c2_pos;   // corr1, corr2 positive and finite
};

// x / y rounded to nearest. Where y is known positive and finite (y_pos)
// a zero x is the quotient itself, sign and all: the division then runs
// on 1 and its result is dropped, since its range check would send a zero
// numerator down its slow path (a select, not a branch: the lanes'
// divisions keep one schedule)
__device__ __forceinline__ float div_pos(float x, float y, bool y_pos) {
  const bool zero = y_pos && x == 0.0f;
  const float q = __fdiv_rn(zero ? 1.0f : x, y);
  return zero ? x : q;
}
// the root rounded to nearest; the root of a zero is that zero
__device__ __forceinline__ float sqrt_z(float x) {
  const bool zero = x == 0.0f;
  const float r = __fsqrt_rn(zero ? 1.0f : x);
  return zero ? x : r;
}
__device__ __forceinline__ bool pos_finite(float y) {
  return y > 0.0f && y < __int_as_float(0x7f800000);
}

// one element, every operation rounded on its own (a gradient of 0, as a
// quantised or delta-masked network gives many, takes no slow path)
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     const Step& k) {
  if (k.clip) g = __fmul_rn(g, k.s);
  m = __fadd_rn(__fmul_rn(k.c.b1, m), __fmul_rn(k.c.omb1, g));
  v = __fadd_rn(__fmul_rn(k.c.b2, v), __fmul_rn(__fmul_rn(k.c.omb2, g), g));
  const float den = __fadd_rn(sqrt_z(div_pos(v, k.c2, k.c2_pos)), k.c.eps);
  float d = div_pos(div_pos(m, k.c1, k.c1_pos), den, pos_finite(den));
  if (k.c.decay) d = __fadd_rn(d, __fmul_rn(k.c.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, d));
}

__device__ __forceinline__ float bf(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ unsigned short to_bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// scalar element i of an operand, and its store
__device__ __forceinline__ float ld1(const float* x, long long i) {
  return __ldcs(x + i);
}
__device__ __forceinline__ float ld1(const __nv_bfloat16* x, long long i) {
  return bf(__ldcs(reinterpret_cast<const unsigned short*>(x) + i));
}
__device__ __forceinline__ void st1(float* x, long long i, float v) {
  __stcs(x + i, v);
}
__device__ __forceinline__ void st1(__nv_bfloat16* x, long long i, float v) {
  __stcs(reinterpret_cast<unsigned short*>(x) + i, to_bf(v));
}

// the piece of 4 elements at element i, whole and on 16 bytes (fp32) or 8
// (bf16): one vector access
__device__ __forceinline__ void ld4(const float* x, long long i, float* o) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(x + i));
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* x, long long i,
                                    float* o) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(x + i));
  o[0] = __uint_as_float(u.x << 16);
  o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16);
  o[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* x, long long i, const float* o) {
  __stcs(reinterpret_cast<float4*>(x + i), make_float4(o[0], o[1], o[2],
                                                       o[3]));
}
__device__ __forceinline__ void st4(__nv_bfloat16* x, long long i,
                                    const float* o) {
  __stcs(reinterpret_cast<uint2*>(x + i),
         make_uint2(static_cast<unsigned>(to_bf(o[0]))
                        | (static_cast<unsigned>(to_bf(o[1])) << 16),
                    static_cast<unsigned>(to_bf(o[2]))
                        | (static_cast<unsigned>(to_bf(o[3])) << 16)));
}

// element i alone
template <class P, class G>
__device__ __forceinline__ void update_one(const Leaf& L, long long i,
                                           const Step& k) {
  float p = ld1(static_cast<const P*>(L.p), i), m = ld1(L.mu, i),
        v = ld1(L.nu, i);
  adam(p, ld1(static_cast<const G*>(L.g), i), m, v, k);
  st1(static_cast<P*>(L.p_out), i, p);
  st1(L.mu_out, i, m);
  st1(L.nu_out, i, v);
}

// tile r of leaf L: a lane's pieces, each by one vector access where it
// is whole and the leaf vec, else element by element up to the leaf's
// end; every piece is loaded before any is computed or stored (the
// outputs may alias the inputs, so the compiler would not move a load
// above a store); tile 0 also takes the head, an element a lane
template <class P, class G>
__device__ void update_tile(const Leaf& L, long long r, const Step& k) {
  const int lane = threadIdx.x & 31;
  const long long base = L.head + r * kTile + lane * kPiece;
  const P* p_in = static_cast<const P*>(L.p);
  const G* g_in = static_cast<const G*>(L.g);
  float p[kPieces][kPiece], g[kPieces][kPiece], m[kPieces][kPiece],
      v[kPieces][kPiece];
  bool whole[kPieces];
#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
    const long long i = base + q * 32 * kPiece;
    whole[q] = L.vec && i + kPiece <= L.n;
    if (whole[q]) {
      ld4(p_in, i, p[q]);
      ld4(g_in, i, g[q]);
      ld4(L.mu, i, m[q]);
      ld4(L.nu, i, v[q]);
    } else {
#pragma unroll
      for (int e = 0; e < kPiece; ++e) {
        const bool in = i + e < L.n;
        p[q][e] = in ? ld1(p_in, i + e) : 0.0f;
        g[q][e] = in ? ld1(g_in, i + e) : 0.0f;
        m[q][e] = in ? ld1(L.mu, i + e) : 0.0f;
        v[q][e] = in ? ld1(L.nu, i + e) : 0.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
#pragma unroll
    for (int e = 0; e < kPiece; ++e) adam(p[q][e], g[q][e], m[q][e], v[q][e],
                                          k);
    const long long i = base + q * 32 * kPiece;
    if (whole[q]) {
      st4(static_cast<P*>(L.p_out), i, p[q]);
      st4(L.mu_out, i, m[q]);
      st4(L.nu_out, i, v[q]);
    } else {
#pragma unroll
      for (int e = 0; e < kPiece; ++e) {
        if (i + e < L.n) {
          st1(static_cast<P*>(L.p_out), i + e, p[q][e]);
          st1(L.mu_out, i + e, m[q][e]);
          st1(L.nu_out, i + e, v[q][e]);
        }
      }
    }
  }
  if (r == 0 && lane < L.head) update_one<P, G>(L, lane, k);
}

template <class P>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    fused_adam_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                      long long items, Consts c, const float* scale,
                      const float* lr_p, const float* corr1_p,
                      const float* corr2_p) {
  // the launch's tile slots in one sweep of the grid, in tree order: warp
  // w of block b takes slots b kWarps + w, then every grid kWarps
  const long long slots = items * kTilesPerChunk;
  const long long lo = static_cast<long long>(blockIdx.x) * kWarps;
  const long long hi = slots;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  if (lo >= hi) return;
  Step k{c, scale != nullptr, scale != nullptr ? *scale : 1.0f, *lr_p,
         *corr1_p, *corr2_p, false, false};
  k.c1_pos = pos_finite(k.c1);
  k.c2_pos = pos_finite(k.c2);
  const long long c_lo = lo / kTilesPerChunk;
  int j = 0, top = n_leaves - 1;   // the last leaf whose chunks start <= c_lo
  while (j < top) {
    const int mid = (j + top + 1) >> 1;
    if (leaves[mid].item0 <= c_lo) j = mid; else top = mid - 1;
  }
  Leaf L = leaves[j];
  long long end = (j + 1 < n_leaves ? leaves[j + 1].item0 : items)
                  * kTilesPerChunk;   // the first slot past leaf j
  for (long long s = lo + (threadIdx.x >> 5); s < hi; s += stride) {
    while (s >= end) {
      L = leaves[++j];
      end = (j + 1 < n_leaves ? leaves[j + 1].item0 : items)
            * kTilesPerChunk;
    }
    const long long r = s - L.item0 * kTilesPerChunk;   // the leaf's tile
    // tiles the leaf has: at least one, for a head alone
    const long long tiles = L.n > L.head ? (L.n - L.head + kTile - 1) / kTile
                                         : 1;
    if (r < tiles) {
      if (L.g_bf16)
        update_tile<P, __nv_bfloat16>(L, r, k);
      else
        update_tile<P, float>(L, r, k);
    }
  }
}

}  // namespace

// p_bf16: 1 for the bf16-parameter instance, 0 for the fp32 one. table: the
// device leaf table, n_leaves rows (no empty leaf), items chunks in all.
// scale: nullptr without clipping. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it cannot run.
extern "C" int fused_adam(int p_bf16, const void* table, int n_leaves,
                          long long items, const float* scale,
                          const float* lr, const float* corr1,
                          const float* corr2, float b1, float omb1, float b2,
                          float omb2, float eps, float wd, int decay, int grid,
                          void* stream) {
  if (table == nullptr || n_leaves <= 0 || items <= 0 || grid <= 0 ||
      lr == nullptr || corr1 == nullptr || corr2 == nullptr ||
      (p_bf16 != 0 && p_bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{b1, omb1, b2, omb2, eps, wd, decay};
  const Leaf* leaves = static_cast<const Leaf*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16)
    fused_adam_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        leaves, n_leaves, items, c, scale, lr, corr1, corr2);
  else
    fused_adam_kernel<float><<<grid, kThreads, 0, st>>>(
        leaves, n_leaves, items, c, scale, lr, corr1, corr2);
  return static_cast<int>(cudaGetLastError());
}
