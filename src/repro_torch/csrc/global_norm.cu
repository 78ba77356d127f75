// The global norm of a gradient tree in one launch, for Hopper (sm_90a):
//   norm = sqrt(sum over leaves, in tree order, of sum(float(leaf) ** 2))
// over fp32 and bf16 leaves in one table, as the plain version
// (global_norm_ref in src/repro_torch/kernels/global_norm.py) computes
// it, apart from the order of the sum within a leaf:
//   1. each element squared in fp32 (__fmul_rn), as leaf.to(float32)
//      squared: a bf16 value past 1.8e19 squares to inf there too;
//   2. each leaf summed in a fixed order: a thread's group of 8 squares
//      (two runs of 4 consecutive elements, 1024 apart) as a fixed fp32
//      tree (4 pairs, 2 pairs of pairs, their sum), then in double: a
//      thread adds its groups in index order, a block its threads in a
//      fixed tree, one partial a chunk of kChunk elements, and the last
//      block the chunks of a leaf in a fixed tree;
//   3. each leaf's sum rounded to fp32;
//   4. the leaves' sums added in tree order in fp32 (__fadd_rn);
//   5. __fsqrt_rn of that.
// Where the caller asks for it, the kernel also writes the total of step 4
// before the root (the sum of squares): a train state sharded over ranks
// adds the ranks' sums and takes the root of that.
// Rounding to fp32 before the root keeps the plain version's overflow: a
// total past the fp32 range is inf there and here, not a finite root of a
// double (a group's fp32 sum past the range is inf, and so is any total
// that holds it). Nothing depends on the grid or on the leaves' alignment:
// a thread's elements are a function of the tree alone, and a leaf that
// does not start on 4 elements' bytes is read element by element in the
// same order, so the result is bitwise the same from call to call and
// from replay to replay.
//
// Replaces no Pallas kernel: the JAX package's norm is an XLA fusion
// inside its jitted train steps (src/repro/train/optim.py:60
// global_norm, called at :67 and :76). Before this kernel the port ran
// it as a cast, a square and a sum a leaf, each writing a full-size
// temporary, and a Python sum over the leaves.
//
// What bounds it on this card: bytes, each gradient read once
// (llama3.2-1b's 1.236 G bf16 gradients: 2.47 GB, 0.74 ms at 3.35 TB/s).
// The design: a grid-stride loop over chunks of 32768 elements, a block a
// chunk (its leaf found by a binary search of the table's first chunks,
// once per 32768 elements); a thread takes 16 groups, each access
// instruction of the block covering 1024 consecutive elements (whole
// 32-byte sectors), with 128 bytes of loads in flight (8 bf16 groups, 4
// fp32 ones) before it adds any; a group's fp32 tree leaves one conversion to
// double and one double add a group (the conversion runs at a quarter of
// the fp32 rate); one double a chunk into a workspace; the last block to
// take the ticket (an integer atomic, as the engine epilogue's) sums the
// workspace a warp a leaf, rounds, adds the leaves and writes the root,
// then sets the ticket back to 0 for the next call or graph replay. No
// float atomics: the sum is the same every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;            // elements a thread's group
constexpr int kGroups = 16;          // groups a thread a chunk
constexpr int kBlocksPerSm = 2;      // resident blocks an SM
constexpr int kSpan = kThreads * kGroup;     // elements of a block's groups
constexpr long long kChunk = (long long)kSpan * kGroups;

// one row of the leaf table: four 8-byte words, as the wrapper writes them
struct Leaf {
  const void* x;
  long long n;        // elements (no empty leaf)
  long long item0;    // the leaf's first chunk in the launch's numbering
  long long bf16;     // 1: bf16, 0: fp32
};
static_assert(sizeof(Leaf) == 32, "the wrapper writes four words a leaf");

__device__ __forceinline__ float bf(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ float lo_bf(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float sq(float x) { return __fmul_rn(x, x); }

// the sum of 8 fp32 squares as a fixed tree (pairs, then pairs of pairs)
__device__ __forceinline__ float tree8(const float (&v)[kGroup]) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(sq(v[0]), sq(v[1])), __fadd_rn(sq(v[2]), sq(v[3]))),
      __fadd_rn(__fadd_rn(sq(v[4]), sq(v[5])), __fadd_rn(sq(v[6]),
                                                           sq(v[7]))));
}

// a group of a thread: two pieces of 4 elements, at c + 4 t and
// c + 1024 + 4 t of a block-wide span of 2048 elements, so that each
// access instruction of a block covers 1024 consecutive elements; a whole
// piece of a leaf that starts on 4 elements' bytes is one access (16
// bytes of fp32, 8 of bf16), packed as loaded
template <class T> struct Piece;
template <> struct Piece<unsigned short> {
  using Raw = uint2;
  static constexpr int kBatch = 8;     // groups loaded at once
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    v[0] = lo_bf(r.x); v[1] = hi_bf(r.x); v[2] = lo_bf(r.y);
    v[3] = hi_bf(r.y);
  }
  static __device__ __forceinline__ float one(const unsigned short* x,
                                              long long i) {
    return bf(__ldg(x + i));
  }
};
template <> struct Piece<float> {
  using Raw = float4;
  static constexpr int kBatch = 4;
  static __device__ __forceinline__ void unpack(const Raw& r, float* v) {
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ float one(const float* x, long long i) {
    return __ldg(x + i);
  }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;   // lane 0's is the warp's
}

// chunk [c0, c1) of a leaf of T: the thread's sum, its groups in order,
// each group's 8 squares a fixed fp32 tree (elements past c1 count 0)
// added in double; kBatch groups' loads in flight
template <class T>
__device__ double chunk_sum(const T* x, long long c0, long long c1) {
  using P = Piece<T>;
  constexpr int kB = P::kBatch;
  const bool vec =
      (reinterpret_cast<uintptr_t>(x) & (4 * sizeof(T) - 1)) == 0;
  double acc = 0.0;
#pragma unroll
  for (int b = 0; b < kGroups; b += kB) {
    typename P::Raw raw[kB][2];
    bool full[kB][2];
#pragma unroll
    for (int k = 0; k < kB; ++k)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long i = c0 + (long long)(b + k) * kSpan + h * (kSpan / 2)
                            + 4 * threadIdx.x;
        full[k][h] = vec && i + 4 <= c1;
        if (full[k][h])
          raw[k][h] = __ldg(reinterpret_cast<const typename P::Raw*>(x + i));
      }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      float v[kGroup];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long i = c0 + (long long)(b + k) * kSpan + h * (kSpan / 2)
                            + 4 * threadIdx.x;
        if (full[k][h]) {
          P::unpack(raw[k][h], v + 4 * h);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[4 * h + e] = i + e < c1 ? P::one(x, i + e) : 0.0f;
        }
      }
      acc += (double)tree8(v);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    global_norm_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                       long long items, double* __restrict__ partial,
                       float* __restrict__ leaf_sum,
                       unsigned int* __restrict__ ticket,
                       float* __restrict__ out,
                       float* __restrict__ squares) {
  __shared__ double warp_part[kWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;  // the last leaf whose chunks start <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (leaves[mid].item0 <= item) lo = mid; else hi = mid - 1;
    }
    const Leaf L = leaves[lo];
    const long long c0 = (item - L.item0) * kChunk;
    const long long c1 = c0 + kChunk < L.n ? c0 + kChunk : L.n;
    const double s = warp_sum(
        L.bf16 ? chunk_sum(static_cast<const unsigned short*>(L.x), c0, c1)
               : chunk_sum(static_cast<const float*>(L.x), c0, c1));
    if (lane == 0) warp_part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      double t = warp_part[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += warp_part[w];
      partial[item] = t;
    }
    __syncthreads();
  }

  // the last block to arrive sums the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = warp; j < n_leaves; j += kWarps) {
    const long long i0 = leaves[j].item0;
    const long long i1 = j + 1 < n_leaves ? leaves[j + 1].item0 : items;
    double t = 0.0;
#pragma unroll 4
    for (long long i = i0 + lane; i < i1; i += 32) t += __ldcg(partial + i);
    t = warp_sum(t);
    if (lane == 0) leaf_sum[j] = __double2float_rn(t);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = n_leaves ? __ldcg(leaf_sum) : 0.0f;
    for (int j = 1; j < n_leaves; ++j)
      total = __fadd_rn(total, __ldcg(leaf_sum + j));
    if (squares != nullptr) *squares = total;
    *out = __fsqrt_rn(total);
    *ticket = 0u;   // ready for the next call or replay
  }
}

}  // namespace

// table: the device leaf table, n_leaves rows (no empty leaf), items
// chunks in all, followed by the ticket word (0 before the first launch;
// the kernel leaves it 0). workspace: items doubles, then n_leaves
// floats. out: one fp32, the norm. squares: one fp32, the sum of squares
// before the root, or null. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for arguments it cannot run.
extern "C" int global_norm(const void* table, int n_leaves, long long items,
                           void* workspace, float* out, float* squares,
                           int grid, void* stream) {
  if (table == nullptr || workspace == nullptr || out == nullptr ||
      n_leaves < 0 || items < 0 || grid <= 0 || (n_leaves == 0) != (items == 0)
      || (reinterpret_cast<uintptr_t>(table) & 7) ||
      (reinterpret_cast<uintptr_t>(workspace) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaf* leaves = static_cast<const Leaf*>(table);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(
      const_cast<Leaf*>(leaves + n_leaves));
  double* partial = static_cast<double*>(workspace);
  float* leaf_sum = reinterpret_cast<float*>(partial + items);
  global_norm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      leaves, n_leaves, items, partial, leaf_sum, ticket, out, squares);
  return static_cast<int>(cudaGetLastError());
}
