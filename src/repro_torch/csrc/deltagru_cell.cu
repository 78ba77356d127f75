// Fused DeltaGRU activation pipeline (paper Fig. 7, Eq. 3) for Hopper
// (sm_90a): from the delta memories m [B, 4H] (r, u, xc, hc) and the two
// matvec results zx = W_x dx, zh = W_h dh [B, 3H] (r, u, c),
//   M_r += zx_r + zh_r, M_u += zx_u + zh_u, M_xc += zx_c, M_hc += zh_c,
//   r = sigmoid(M_r), u = sigmoid(M_u), c = tanh(M_xc + r * M_hc),
//   h = (1 - u) * c + u * h_prev.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/deltagru_cell.py::_kernel
// (pallas_call in deltagru_act), which tiles the hidden dim in 128-lane
// blocks over [B, g, block_h] gate views.
//
// What bounds it on this card: bytes. 16 floats move per (b, h) (11 read,
// 5 written) for a few dozen operations; at 2L-768H and B = 1 that is
// 49 KB, 0.015 us at 3.35 TB/s, far below what a launch costs. So the
// design keeps the kernel to a launch and one round trip.
//
// What the design does about it: a thread owns one channel (b, o) and
// issues its 11 4-byte loads before any arithmetic, then its 5 stores; a
// thread's chain of dependent work, not the bytes, sets the time once the
// launch is paid, so the work is spread one channel a thread. (Four
// channels a thread with 16-byte loads and stores, and two with 8-byte
// ones, were slower at B = 1 and 8: tools/act_times.py --breakdown.) Any
// contiguous 4-byte aligned view runs the same path, and the grid's last
// block masks the channels past B * H. The host plan
// (kernels/deltagru_cell.py::deltagru_act_plan) picks the threads a block
// and a grid of at most the blocks the SMs hold at once; a thread walks the
// channels in turn. The launch is a programmatic dependent launch: the
// grid may be scheduled while the kernel before it on the stream (the
// delta_spmv that writes zh) finishes, and waits for it
// (griddepcontrol.wait) before it reads anything. The arithmetic is that
// of the plain version: each sum and product rounded on its own (no fused
// multiply-add), sigmoid as 1 / (1 + exp(-x)), IEEE expf / tanhf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct ActArgs {
  const float *m, *zx, *zh, *h_prev;
  float *m_out, *h_out;
  int H, units;
};

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void deltagru_act_kernel(const ActArgs p) {
  // the kernels before this one on the stream are done and visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int H = p.H;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < p.units;
       idx += gridDim.x * blockDim.x) {
    const int b = idx / H;
    const int o = idx - b * H;
    const float* m = p.m + (size_t)b * 4 * H + o;
    const float* x = p.zx + (size_t)b * 3 * H + o;
    const float* g = p.zh + (size_t)b * 3 * H + o;
    const float m0 = m[0], m1 = m[H], m2 = m[2 * H], m3 = m[3 * H];
    const float x0 = x[0], x1 = x[H], x2 = x[2 * H];
    const float g0 = g[0], g1 = g[H], g2 = g[2 * H];
    const float hp = p.h_prev[idx];
    const float m_r = __fadd_rn(__fadd_rn(m0, x0), g0);
    const float m_u = __fadd_rn(__fadd_rn(m1, x1), g1);
    const float m_xc = __fadd_rn(m2, x2);
    const float m_hc = __fadd_rn(m3, g2);
    const float r = sigmoid_f(m_r);
    const float u = sigmoid_f(m_u);
    const float c = tanhf(__fadd_rn(m_xc, __fmul_rn(r, m_hc)));
    float* mo = p.m_out + (size_t)b * 4 * H + o;
    mo[0] = m_r;
    mo[H] = m_u;
    mo[2 * H] = m_xc;
    mo[3 * H] = m_hc;
    p.h_out[idx] = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c),
                             __fmul_rn(u, hp));
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

// m_prev, m_out [B, 4H]; zx, zh [B, 3H]; h_prev, h_out [B, H]; all fp32,
// contiguous, 4-byte aligned. The plan
// (kernels/deltagru_cell.py::deltagru_act_plan): threads a block (32, 64,
// 128 or 256) and grid (blocks, at most enough for one channel a thread:
// the threads walk the B * H channels in turn). A plan or an operand the
// kernel cannot take returns cudaErrorInvalidValue. Launches on `stream`
// (a programmatic dependent launch) and returns cudaGetLastError() (0 on
// success).
extern "C" int deltagru_act_f32(const void* m_prev, const void* zx,
                                const void* zh, const void* h_prev,
                                void* m_out, void* h_out, int B, int H,
                                int threads, int grid, void* stream) {
  if (B < 0 || H < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  if (threads != 32 && threads != 64 && threads != 128 && threads != 256)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * H;
  if (4 * units > (1LL << 31) - 1 || grid < 1 ||
      grid > (units + threads - 1) / threads)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {m_prev, zx, zh, h_prev, m_out, h_out};
  for (const void* q : ptrs)
    if (q == nullptr || ((uintptr_t)q & 3)) return (int)cudaErrorInvalidValue;
  const ActArgs p{(const float*)m_prev, (const float*)zx,
                  (const float*)zh,     (const float*)h_prev,
                  (float*)m_out,        (float*)h_out,
                  H,                    (int)units};
  const cudaError_t err = launch_pdl(deltagru_act_kernel, grid, threads,
                                     (cudaStream_t)stream, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// An empty kernel of this build, launched as the activation is (a
// programmatic dependent launch) as blocks x threads: the floor under a
// launch of the activation at the same grid.
extern "C" int deltagru_act_empty(int blocks, int threads, void* stream) {
  const cudaError_t err =
      launch_pdl(empty_kernel, blocks, threads, (cudaStream_t)stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
