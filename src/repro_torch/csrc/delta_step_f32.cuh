// The fp32 fused delta-RNN layer step for Hopper (sm_90a), one template over
// the cell: G = 3 gate rows (the GRU, candidate routed on the x/h seam) or
// G = 4 (the LSTM, every gate takes both streams). deltagru_seq.cu and
// deltalstm_seq.cu each instantiate their cell.
//
// It computes: walk only the fired block_k column blocks of the packed
// [G, Hp, K] fp32 volume (K = ip + hk, the x columns then the h columns,
// each padded to block_k), accumulate d @ w.T into the delta memories, then
//   GRU:  r, u = sigmoid(M_r, M_u), c = tanh(M_xc + r * M_hc),
//         h = (1 - u) * c + u * h_prev;
//   LSTM: i, f, o = sigmoid(M), g = tanh(M_g), c = f * c_prev + i * g,
//         h = o * tanh(c).
//
// What bounds it on this card: the fired weight bytes, G * Hp * block_k * 4
// per fired block (28.8 MB for a fully fired 2L-768H LSTM step, 8.6 us at
// 3.35 TB/s; the packed volumes fit the 50 MB L2). At batch 1 a step does 2
// operations per 4-byte weight, far below the fp32 rate. At ~10 % fired the
// bytes take less time than a launch, and what sets the time is the chain of
// dependent round trips between a launch's first load and its last store.
//
// What the design does about it (the int8 / int4 kernels' template,
// delta_q8.cu, at 4 bytes a weight):
// - kSplit = 3 warps per output row, kRows = 6 rows a block (128 blocks of
//   18 warps at H = 768: one wave, on 128 of the 132 SMs); lane 8 g + s
//   walks gate row g (lanes past 8 G idle). The warps of a row take its
//   unrolled groups in turn, so three times the loads are in flight on an
//   SM and a warp waits on a third of the round trips; the others hand
//   their partial memories to the row's first warp through shared memory
//   (one barrier), which adds them in a fixed order and runs the
//   activation. With one warp a row the fully fired LSTM step took about
//   16.5 us on the H100, with three 11.9, the same for every cell and
//   instance (tools/f32_variants.py, PERF.md).
// - The one-barrier prologue of delta_walk.cuh; the operands of the
//   activation stage (m_prev, and h_prev or c_prev) are loaded before it.
// - A walk with many bytes in flight: the 8 lanes of a gate read 16 bytes
//   each (128 contiguous bytes a step), and a lane issues the loads of
//   kUnroll = 8 steps (2 fired 128-column blocks of its gate row) before
//   its first product; with the groups spread over 3 warps, the 12 fired
//   blocks of a 1536-column layer cost 2 round trips a warp.
// - Accumulators sized to the streams: one-stream (NB = 1: one accumulator
//   a lane, two for the GRU candidate) and tile (NB = kMaxB streams a pass)
//   instances, picked by the host's launch plan.
// - Each gate's expf / tanhf on its own lanes (lane 8 g + b: gate g of
//   stream b), the blend on one of them.
// Numerics of the plain version: IEEE expf / tanhf / division (no fast
// math), the blend lines rounded product by product (__fmul_rn /
// __fadd_rn); the sums run in another order, so the result agrees within
// an fp32 bound, not bitwise.
#pragma once

#include <cuda_runtime.h>

#include "delta_walk.cuh"

namespace delta_step_f32 {
// internal linkage: each source that includes the template builds its own
// library, and no symbol of one may stand in for the other's
namespace {

using delta_walk::dpos;
using delta_walk::kMaxB;

constexpr int kRows = 6;    // output rows a block
constexpr int kSplit = 3;   // warps a row's walk is spread over
constexpr int kUnroll = 8;  // float4 loads a lane has in flight
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

enum Instance { kOneStream = 0, kTile = 1 };

// The operands of one layer step. s_prev is h_prev (GRU) or c_prev (LSTM);
// c_out is written by the LSTM only. chunk comes from the plan.
struct StepArgs {
  const float *w, *m_prev, *s_prev, *dx, *dh;
  float *m_out, *h_out, *c_out;
  int B, I, H, Hp, K, ip, block_k, chunk;
};

// Dynamic shared memory of a launch: the staged deltas [chunk][kpad(K)],
// the vote words, each warp's list of fired block ids and the partial
// memories the other warps of a row hand to its first ([kSplit - 1][kRows]
// [2][32]). Mirrored by f32_smem_bytes in
// repro_torch/kernels/delta_step_f32.py; launch_step refuses a plan whose
// smem differs.
__host__ inline size_t smem_bytes(int K, int block_k, int chunk) {
  return (size_t)chunk * delta_walk::kpad(K) * sizeof(float) +
         (size_t)((chunk * (K / 4) + 31) / 32) * sizeof(unsigned) +
         (size_t)kRows * kSplit * (K / block_k) * sizeof(int) +
         (size_t)(kSplit - 1) * kRows * 64 * sizeof(float);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float dot4(float4 d, float4 w, float s) {
  s = fmaf(d.x, w.x, s);
  s = fmaf(d.y, w.y, s);
  s = fmaf(d.z, w.z, s);
  return fmaf(d.w, w.w, s);
}

// Add this warp's share of the fired blocks to its output row o: lane l
// walks gate g = l / 8, the 8 lanes of a gate stepping over the (fired
// block, vector) pairs of the gate row 8 vectors at a time, kUnroll steps
// a group, every load of a group issued before its first product; the
// kSplit warps of a row take its groups in turn (this one, share s, every
// kSplit-th from the s-th). acc[b] is this lane's gate memory for stream
// b; acc_h[b] takes the GRU candidate row's blocks right of the x/h seam
// (M_hc).
template <int G, int NB>
__device__ __forceinline__ void walk(const StepArgs& a, const int* ids, int n,
                                     const float* d_s, int stride, int bc,
                                     int o, int s, int lane,
                                     float (&acc)[NB], float (&acc_h)[NB]) {
  constexpr int U = kUnroll;
  const int g = lane >> 3, sub = lane & 7;
  const bool active = g < G;
  const int L = a.block_k >> 2;  // float4 vectors a gate row has in a block
  const int lsh = (L & (L - 1)) == 0 ? __ffs(L) - 1 : -1;
  const float* src = a.w + ((size_t)(active ? g : 0) * a.Hp + o) * a.K;
  const int total = n * L;
  for (int u0 = s * 8 * U; u0 < total; u0 += kSplit * 8 * U) {
    float4 wv[U];
    int col[U];
#pragma unroll
    for (int t = 0; t < U; ++t) {
      const int u = u0 + 8 * t + sub;
      col[t] = -1;
      if (active && u < total) {
        const int j = lsh >= 0 ? u >> lsh : u / L;
        col[t] = ids[j] * a.block_k + ((u - j * L) << 2);
        wv[t] = __ldg(reinterpret_cast<const float4*>(src + col[t]));
      }
    }
#pragma unroll
    for (int t = 0; t < U; ++t) {
      if (col[t] >= 0) {
        const int p = dpos(col[t]);
        const bool to_h = G == 3 && g == 2 && col[t] >= a.ip;
#pragma unroll
        for (int bb = 0; bb < NB; ++bb) {
          if (bb < bc) {
            const float4 d =
                *reinterpret_cast<const float4*>(d_s + bb * stride + p);
            if (to_h) acc_h[bb] = dot4(d, wv[t], acc_h[bb]);
            else acc[bb] = dot4(d, wv[t], acc[bb]);
          }
        }
      }
    }
  }
}

template <int G, int NB>
__global__ void __launch_bounds__(kRows * kSplit * 32)
    delta_step_f32_kernel(const StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = a.K, H = a.H;
  const int nbk = K / a.block_k;
  const int stride = delta_walk::kpad(K);
  float* d_s = reinterpret_cast<float*>(smem);
  unsigned* vmask = reinterpret_cast<unsigned*>(d_s + a.chunk * stride);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, sub = lane & 7;
  int* ids_all =
      reinterpret_cast<int*>(vmask + (a.chunk * (K / 4) + 31) / 32);
  int* ids = ids_all + warp * nbk;
  float* part = reinterpret_cast<float*>(ids_all + kRows * kSplit * nbk);
  const int ri = warp % kRows, s = warp / kRows;  // row, share of the walk
  const int o = blockIdx.x * kRows + ri;
  const bool row = o < H;

  for (int b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int bc = min(a.chunk, a.B - b0);
    // Lane 8 g + b of a row's first warp finishes gate g of stream b0 + b;
    // its operands are loaded before anything waits on them. The GRU's
    // candidate lanes also take M_hc; the lanes that blend (LSTM: gate 0,
    // GRU: the candidate) read the previous state.
    const bool gate_lane = row && s == 0 && g < G && sub < bc;
    const bool blender = gate_lane && g == (G == 3 ? 2 : 0);
    const size_t mb = (size_t)(b0 + sub) * 4 * H;
    const size_t hb = (size_t)(b0 + sub) * H + o;
    float mp = 0.0f, mp_h = 0.0f, sp = 0.0f;
    if (gate_lane) {
      mp = __ldg(a.m_prev + mb + g * H + o);
      if (G == 3 && g == 2) mp_h = __ldg(a.m_prev + mb + 3 * H + o);
    }
    if (blender) sp = __ldg(a.s_prev + hb);

    delta_walk::stage_deltas<4>(a.dx, a.dh, d_s, vmask, b0, bc, a.I, H, K,
                                a.ip);
    __syncthreads();  // d_s and vmask visible to all
    const int n =
        delta_walk::warp_fired_blocks(vmask, ids, bc, K, a.block_k, lane);

    float acc[NB], acc_h[NB];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) acc[bb] = acc_h[bb] = 0.0f;
    if (row)
      walk<G, NB>(a, ids, n, d_s, stride, bc, o, s, lane, acc, acc_h);

    // each gate's memory over its 8 lanes; lane 8 g + b keeps stream b's
    float mine = 0.0f, mine_h = 0.0f;
    if (row) {
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
        if (bb < bc) {
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) {
            acc[bb] += __shfl_xor_sync(kFull, acc[bb], off);
            if (G == 3) acc_h[bb] += __shfl_xor_sync(kFull, acc_h[bb], off);
          }
          if (sub == bb) {
            mine = acc[bb];
            mine_h = acc_h[bb];
          }
        }
      }
    }
    // the row's other warps hand their shares to its first, which adds
    // them in share order
    if (s > 0) {
      float* p = part + ((s - 1) * kRows + ri) * 64;
      p[lane] = mine;
      p[32 + lane] = mine_h;
    }
    __syncthreads();
    if (row && s == 0) {
#pragma unroll
      for (int q = 1; q < kSplit; ++q) {
        const float* p = part + ((q - 1) * kRows + ri) * 64;
        mine += p[lane];
        mine_h += p[32 + lane];
      }
      const float m = mp + mine;
      if (gate_lane) a.m_out[mb + g * H + o] = m;
      if constexpr (G == 3) {
        const float m_h = mp_h + mine_h;
        if (gate_lane && g == 2) a.m_out[mb + 3 * H + o] = m_h;
        const float ru = g < 2 ? sigmoid_f(m) : 0.0f;
        const float r = __shfl_sync(kFull, ru, sub);
        const float u = __shfl_sync(kFull, ru, 8 + sub);
        if (blender) {
          // no FMA contraction: round each product as the plain version
          const float c = tanhf(__fadd_rn(m, __fmul_rn(r, m_h)));
          a.h_out[hb] =
              __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c), __fmul_rn(u, sp));
        }
      } else {
        const float act = g == 2 ? tanhf(m) : sigmoid_f(m);
        const float gi = __shfl_sync(kFull, act, sub);
        const float gf = __shfl_sync(kFull, act, 8 + sub);
        const float gg = __shfl_sync(kFull, act, 16 + sub);
        const float go = __shfl_sync(kFull, act, 24 + sub);
        if (blender) {
          const float c = __fadd_rn(__fmul_rn(gf, sp), __fmul_rn(gi, gg));
          a.c_out[hb] = c;
          a.h_out[hb] = __fmul_rn(go, tanhf(c));
        }
      }
    }
    if (b0 + a.chunk < a.B) __syncthreads();  // the next pass restages d_s
  }
}

template <int G, int NB>
int launch(const StepArgs& a, int smem, int device, cudaStream_t stream) {
  // the dynamic shared memory this instance may take, raised once per
  // device as plans ask for more (no CUDA API call on a launch that fits)
  static int allowed[kMaxDevices] = {};
  auto kernel = delta_step_f32_kernel<G, NB>;
  if (smem > 48 * 1024) {
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
    if (smem > allowed[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      allowed[device] = smem;
    }
  }
  const dim3 grid((a.H + kRows - 1) / kRows);
  kernel<<<grid, kRows * kSplit * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Check a launch plan (instance, chunk, smem, device) against the layout
// and what the kernel lays out, then launch the instance it names.
template <int G>
int launch_step(const StepArgs& a, int instance, int smem, int device,
                void* stream) {
  if (a.B <= 0 || a.H <= 0) return 0;
  if (a.block_k <= 0 || a.block_k % 4 || a.K % a.block_k ||
      a.ip % a.block_k)
    return (int)cudaErrorInvalidValue;
  if (instance == kOneStream ? a.chunk != 1
                             : (instance != kTile || a.chunk < 1 ||
                                a.chunk > kMaxB))
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem != smem_bytes(a.K, a.block_k, a.chunk))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return instance == kOneStream ? launch<G, 1>(a, smem, device, s)
                                : launch<G, kMaxB>(a, smem, device, s);
}

}  // namespace
}  // namespace delta_step_f32
