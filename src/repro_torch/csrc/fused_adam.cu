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
// 3.35 TB/s. The design is the simplest that streams them: a grid-stride
// loop over chunks of kChunk elements of any leaf, a block a chunk, each
// block finding its leaf by a binary search of the table's first chunks;
// scalar loads and stores, so a leaf of any size and any element alignment
// is taken as it is. The table (pointers, lengths, the gradient's type,
// first chunks) lives in device memory, written by the wrapper: a captured
// graph keeps the table's address and not its bytes, so the table is
// written once a capture, and the launch's arguments stay small.
//
// Every multiply, add, divide and square root is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc would contract a
// multiply and an add into one fma, and the plain version's PyTorch
// kernels round each operation, so the result is bitwise theirs (R3).
// The scale, lr, corr1 and corr2 are 0-d device tensors that the plain ops
// of the step compute (the global norm, the schedule, 1 - b ** t): the
// kernel reads them from device memory, so nothing waits for the host and
// a graph stays valid from step to step. b1, 1 - b1, b2, 1 - b2, eps and wd
// come from the host, each rounded from a double as PyTorch rounds a
// scalar operand of a float32 op.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;   // elements of a leaf a block takes

// one row of the leaf table: ten 8-byte words, as the wrapper writes them
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
};
static_assert(sizeof(Leaf) == 80, "the wrapper writes ten words a leaf");

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
  int decay;
};

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <class P, class G>
__device__ __forceinline__ void update_chunk(const Leaf& L, long long i0,
                                             long long i1, const Consts& c,
                                             const float* scale, float s,
                                             float lr, float c1, float c2) {
  const P* p = static_cast<const P*>(L.p);
  const G* g = static_cast<const G*>(L.g);
  P* p_out = static_cast<P*>(L.p_out);
  for (long long i = i0 + threadIdx.x; i < i1; i += kThreads) {
    float gi = load_f32(g, i);
    if (scale != nullptr) gi = __fmul_rn(gi, s);
    const float pi = load_f32(p, i);
    const float m = __fadd_rn(__fmul_rn(c.b1, L.mu[i]), __fmul_rn(c.omb1, gi));
    const float v = __fadd_rn(__fmul_rn(c.b2, L.nu[i]),
                              __fmul_rn(__fmul_rn(c.omb2, gi), gi));
    float d = __fdiv_rn(__fdiv_rn(m, c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), c.eps));
    if (c.decay) d = __fadd_rn(d, __fmul_rn(c.wd, pi));
    store(p_out, i, __fsub_rn(pi, __fmul_rn(lr, d)));
    L.mu_out[i] = m;
    L.nu_out[i] = v;
  }
}

template <class P>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                      long long items, Consts c, const float* scale,
                      const float* lr_p, const float* corr1_p,
                      const float* corr2_p) {
  const float s = scale != nullptr ? *scale : 1.0f;
  const float lr = *lr_p, c1 = *corr1_p, c2 = *corr2_p;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;  // the last leaf whose chunks start <= item
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (leaves[mid].item0 <= item) lo = mid; else hi = mid - 1;
    }
    const Leaf L = leaves[lo];
    const long long i0 = (item - L.item0) * kChunk;
    const long long i1 = i0 + kChunk < L.n ? i0 + kChunk : L.n;
    if (L.g_bf16)
      update_chunk<P, __nv_bfloat16>(L, i0, i1, c, scale, s, lr, c1, c2);
    else
      update_chunk<P, float>(L, i0, i1, c, scale, s, lr, c1, c2);
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
