// Variants of csrc/deltagru_cell.cu's deltagru_act for tools/act_times.py
// --breakdown: V = 1, 2 or 4 channels a thread, moved with V-wide loads and
// stores (4, 8 or 16 bytes), write-back or streaming (st.global.cs)
// stores, always a programmatic dependent launch that waits before it
// reads. The arithmetic is the kernel's, so every variant gives the plain
// version's bits. Needs H % V == 0 and every pointer aligned to 4 V bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ void load(const float* p, float (&x)[V]) {
  const typename Vec<V>::T q = *reinterpret_cast<const typename Vec<V>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&q);
#pragma unroll
  for (int c = 0; c < V; ++c) x[c] = f[c];
}

template <int V, bool STREAM>
__device__ __forceinline__ void store(float* p, const float (&x)[V]) {
  typename Vec<V>::T q;
  float* f = reinterpret_cast<float*>(&q);
#pragma unroll
  for (int c = 0; c < V; ++c) f[c] = x[c];
  if constexpr (STREAM)
    __stcs(reinterpret_cast<typename Vec<V>::T*>(p), q);
  else
    *reinterpret_cast<typename Vec<V>::T*>(p) = q;
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int V, bool STREAM>
__global__ void act_kernel(const float* m, const float* zx, const float* zh,
                           const float* h_prev, float* m_out, float* h_out,
                           int H, int units) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = H / V;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += gridDim.x * blockDim.x) {
    const int b = u / row, o = (u - b * row) * V;
    const float* mm = m + (size_t)b * 4 * H + o;
    const float* x = zx + (size_t)b * 3 * H + o;
    const float* g = zh + (size_t)b * 3 * H + o;
    float m0[V], m1[V], m2[V], m3[V], x0[V], x1[V], x2[V], g0[V], g1[V],
        g2[V], hp[V], h[V];
    load<V>(mm, m0), load<V>(mm + H, m1), load<V>(mm + 2 * H, m2);
    load<V>(mm + 3 * H, m3);
    load<V>(x, x0), load<V>(x + H, x1), load<V>(x + 2 * H, x2);
    load<V>(g, g0), load<V>(g + H, g1), load<V>(g + 2 * H, g2);
    load<V>(h_prev + (size_t)b * H + o, hp);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      m0[c] = __fadd_rn(__fadd_rn(m0[c], x0[c]), g0[c]);
      m1[c] = __fadd_rn(__fadd_rn(m1[c], x1[c]), g1[c]);
      m2[c] = __fadd_rn(m2[c], x2[c]);
      m3[c] = __fadd_rn(m3[c], g2[c]);
      const float r = sigmoid_f(m0[c]), uu = sigmoid_f(m1[c]);
      const float cc = tanhf(__fadd_rn(m2[c], __fmul_rn(r, m3[c])));
      h[c] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, uu), cc),
                       __fmul_rn(uu, hp[c]));
    }
    float* q = m_out + (size_t)b * 4 * H + o;
    store<V, STREAM>(q, m0), store<V, STREAM>(q + H, m1);
    store<V, STREAM>(q + 2 * H, m2), store<V, STREAM>(q + 3 * H, m3);
    store<V, STREAM>(h_out + (size_t)b * H + o, h);
  }
}

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

template <int V, bool STREAM>
cudaError_t run(const void* const* p, int B, int H, int threads,
                cudaStream_t stream) {
  const int units = B * (H / V);
  return launch_pdl(act_kernel<V, STREAM>, (units + threads - 1) / threads,
                    threads, stream, (const float*)p[0], (const float*)p[1],
                    (const float*)p[2], (const float*)p[3], (float*)p[4],
                    (float*)p[5], H, units);
}

}  // namespace

// The six pointers of deltagru_act_f32, B, H, V (1, 2 or 4), streaming
// stores (0 or 1), threads a block; one channel group a thread (no grid
// walk). Returns cudaErrorInvalidValue for a V, width or alignment it
// cannot take, else cudaGetLastError().
extern "C" int act_variant(const void* m, const void* zx, const void* zh,
                           const void* h_prev, void* m_out, void* h_out,
                           int B, int H, int V, int stream_stores,
                           int threads, void* stream) {
  const void* p[] = {m, zx, zh, h_prev, m_out, h_out};
  if ((V != 1 && V != 2 && V != 4) || B < 1 || H < 1 || H % V ||
      threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  for (const void* q : p)
    if ((uintptr_t)q % (4 * V)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (V == 1)
    err = stream_stores ? run<1, true>(p, B, H, threads, s)
                        : run<1, false>(p, B, H, threads, s);
  else if (V == 2)
    err = stream_stores ? run<2, true>(p, B, H, threads, s)
                        : run<2, false>(p, B, H, threads, s);
  else
    err = stream_stores ? run<4, true>(p, B, H, threads, s)
                        : run<4, false>(p, B, H, threads, s);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
