// int8 / int4 fused delta-RNN layer steps for Hopper (sm_90a): the GRU and the
// LSTM cell, each in a plain and a double-buffered form.
//
// Replaces: the Pallas TPU kernels of src/repro/kernels/delta_q8.py at
// weight_bits 8 and 4:
//   _q8_gru_kernel       (public entry deltagru_q8_step),
//   _q8_gru_kernel_dbuf  (deltagru_q8_step(buffered=True)),
//   _q8_lstm_kernel      (deltalstm_q8_step),
//   _q8_lstm_kernel_dbuf (deltalstm_q8_step(buffered=True)).
// They compute the same function: walk only the fired block_k column blocks of
// the packed [G, Hp, K] volume of int8 codes (or [G, Hp, K/2] nibble-packed
// int4 codes), G = 3 gate rows for the GRU and 4 for the LSTM, and accumulate
// the unscaled code-domain products delta * code in fp32 (the PE's integer
// accumulator: every product and partial sum of Q8.8 deltas and small integer
// codes is exact, so any summation order gives the same bits). The GRU routes
// its candidate gate on the x/h seam into M_xc / M_hc; each LSTM gate takes
// both streams. Then dequantize b4 + s * M and run the activation stage on the
// Q8.8-input / Q1.4-output LUT grids:
//   GRU:  r, u = lut(sigmoid(q88(.))), c = lut(tanh(q88(xc + r * hc))),
//         h = q88((1 - u) * c + u * h_prev);
//   LSTM: i, f, o = lut(sigmoid(q88(.))), g = lut(tanh(q88(.))),
//         c = q88(f * c_prev + i * g)  (saturates at the Q8.8 rails, never
//         wraps), h = q88(o * lut(tanh(c))).
// The LSTM kernels take no h_prev: h = o * tanh(c) reads only the cell state.
//
// int4 layout (pack_nibbles): inside each block_k column block, byte j holds
// column j in its low nibble and column j + block_k/2 in its high nibble; a
// nibble n decodes as ((n & 15) ^ 8) - 8.
//
// What bounds it on this card: the fired weight bytes, G * Hp * block_k bytes
// per fired block at int8 (half that at int4), over memory bandwidth. At
// 2L-768H with every block fired a GRU step streams 5.6 MB (int8) or 2.8 MB
// (int4), an LSTM step 7.5 MB or 3.7 MB: 1.7 / 0.84 us and 2.2 / 1.1 us at
// 3.35 TB/s. The operations (2 per code per stream) are far below any compute
// rate at batch 1.
//
// What the design does about it: the walk of deltagru_seq.cu (one warp per
// output row, fired blocks compacted by each thread block on the device,
// deltas staged in shared memory: delta_walk.cuh), with each lane reading
// 4 code bytes (int8) or 2 packed bytes (int4) of a gate row, so a warp reads
// 128 or 64 contiguous bytes per gate row and block. The TPU's double-buffered
// kernels keep the weights in HBM and overlap the DMA of fired block j+1 with
// the sum over block j through a two-slot VMEM ring. Here the buffered form
// does the same with cp.async: every thread of the block copies 16 bytes of
// block j+1's rows (kWarps rows x G gates x block_k bytes) into the other slot
// of a two-slot shared-memory ring while the warps sum block j from theirs;
// commit_group / wait_group and a barrier per block order the slots, and no
// copy is issued when nothing fired. The sums are exact, so both forms give
// the same bits. The stage after the sum keeps the JAX package's op order and
// rounding exactly: no FMA contraction on the dequant, the candidate sum or the
// blends (__fmul_rn / __fadd_rn), IEEE expf / tanhf / division (no fast math),
// and rintf (half to even) for every grid rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include "delta_walk.cuh"

namespace {

using delta_walk::kMaxB;
using delta_walk::kWarps;

struct Grid {  // a Qm.n grid: round(v * scale) / scale, clipped to [lo, hi]
  float scale, lo, hi;
};

__device__ __forceinline__ float grid_round(float v, Grid g) {
  const float q = __fdiv_rn(rintf(__fmul_rn(v, g.scale)), g.scale);
  return fminf(fmaxf(q, g.lo), g.hi);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// The activation stage shared by the kernels and the exhaustive grid check.
__device__ __forceinline__ float lut_sigmoid(float x, Grid act, Grid lut) {
  return grid_round(sigmoid_f(grid_round(x, act)), lut);
}

__device__ __forceinline__ float lut_tanh(float x, Grid act, Grid lut) {
  return grid_round(tanhf(grid_round(x, act)), lut);
}

__device__ __forceinline__ float nib(int p) { return (float)(((p & 15) ^ 8) - 8); }

// The operands of one layer step. s_prev is h_prev (GRU) or c_prev (LSTM);
// c_out is written by the LSTM only.
struct StepArgs {
  const int8_t* w_q;
  const float *scales, *b4, *m_prev, *s_prev, *dx, *dh;
  float *m_out, *h_out, *c_out;
  int B, I, H, Hp, K, ip, block_k, chunk;
  Grid act, lut;
};

template <bool SMEM, typename T>
__device__ __forceinline__ T load(const int8_t* p) {
  if constexpr (SMEM) return *reinterpret_cast<const T*>(p);
  else return __ldg(reinterpret_cast<const T*>(p));
}

// Add one fired block to the accumulators of this warp's output row.
// rows[g] points at gate row g's bytes of the block (in device memory, or in
// the shared-memory ring when SMEM); kbase is the block's first column.
// acc[0..3] are M_r, M_u, M_xc, M_hc (GRU: the candidate row goes to M_xc left
// of the x/h seam, to M_hc right of it) or M_i, M_f, M_g, M_o (LSTM).
template <int G, int BITS, bool SMEM>
__device__ __forceinline__ void accumulate_block(
    const int8_t* const (&rows)[G], const float* d_s, int K, int kbase,
    int block_k, int bc, int lane, bool is_x, float (&acc)[4][kMaxB]) {
  if constexpr (BITS == 8) {
    for (int c = lane * 4; c < block_k; c += 128) {
      char4 w[G];
#pragma unroll
      for (int g = 0; g < G; ++g) w[g] = load<SMEM, char4>(rows[g] + c);
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb < bc) {
          const float4 d =
              *reinterpret_cast<const float4*>(d_s + bb * K + kbase + c);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p =
                d.x * w[g].x + d.y * w[g].y + d.z * w[g].z + d.w * w[g].w;
            if (G == 3 && g == 2 && !is_x) acc[3][bb] += p;
            else acc[g][bb] += p;
          }
        }
      }
    }
  } else {
    const int half = block_k / 2;
    for (int jj = lane * 2; jj < half; jj += 64) {
      // columns kbase+jj, +jj+1 (low nibbles), +half+jj, +half+jj+1 (high)
      float w[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const char2 p = load<SMEM, char2>(rows[g] + jj);
        w[g][0] = nib(p.x);
        w[g][1] = nib(p.y);
        w[g][2] = nib(p.x >> 4);
        w[g][3] = nib(p.y >> 4);
      }
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb < bc) {
          const float2 dl =
              *reinterpret_cast<const float2*>(d_s + bb * K + kbase + jj);
          const float2 dhi = *reinterpret_cast<const float2*>(
              d_s + bb * K + kbase + half + jj);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = dl.x * w[g][0] + dl.y * w[g][1] +
                            dhi.x * w[g][2] + dhi.y * w[g][3];
            if (G == 3 && g == 2 && !is_x) acc[3][bb] += p;
            else acc[g][bb] += p;
          }
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of fired block kb's rows for this thread block's kWarps
// output rows into one ring slot laid out [kWarps][G][wbk], 16 bytes per
// thread and copy; rows past H are not copied (no warp reads them).
template <int G>
__device__ __forceinline__ void copy_block(int8_t* slot, const StepArgs& a,
                                           int kb, int wbk, size_t row) {
  const int per_row = wbk / 16;
  const int o0 = blockIdx.x * kWarps;
  for (int q = threadIdx.x; q < kWarps * G * per_row; q += blockDim.x) {
    const int rg = q / per_row;
    const int part = q - rg * per_row;
    const int w = rg / G;
    const int g = rg - w * G;
    if (o0 + w < a.H)
      cp_async16(slot + (size_t)rg * wbk + part * 16,
                 a.w_q + ((size_t)g * a.Hp + o0 + w) * row +
                     (size_t)kb * wbk + part * 16);
  }
  cp_async_commit();
}

template <int G, int BITS, bool BUF>
__global__ void __launch_bounds__(kWarps * 32) delta_q8_kernel(StepArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.K, H = a.H, Hp = a.Hp, block_k = a.block_k;
  const int wbk = BITS == 8 ? block_k : block_k / 2;  // row bytes per block
  const size_t row = BITS == 8 ? (size_t)K : (size_t)K / 2;
  const int slot_bytes = kWarps * G * wbk;
  int8_t* ring = reinterpret_cast<int8_t*>(smem4);  // [2][kWarps][G][wbk]
  float* d_s =
      reinterpret_cast<float*>(ring + (BUF ? 2 * slot_bytes : 0));  // [chunk][K]
  int* fired = reinterpret_cast<int*>(d_s + a.chunk * K);           // [nbk]
  int* ids = fired + K / block_k;                                   // [nbk]
  __shared__ int n_active;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o = blockIdx.x * kWarps + warp;
  const int nbk_x = a.ip / block_k;

  for (int b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int bc = min(a.chunk, a.B - b0);
    delta_walk::stage_fired_blocks(a.dx, a.dh, d_s, fired, ids, &n_active,
                                   b0, bc, a.I, H, K, a.ip, block_k);
    const int n = n_active;
    float acc[4][kMaxB];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) acc[m][bb] = 0.0f;
    if constexpr (BUF) {
      // every thread copies and waits; the warps of rows < H also sum
      if (n > 0) copy_block<G>(ring, a, ids[0], wbk, row);
      for (int j = 0; j < n; ++j) {
        if (j + 1 < n) {
          copy_block<G>(ring + ((j + 1) & 1) * slot_bytes, a, ids[j + 1], wbk,
                        row);
          cp_async_wait<1>();  // block j has landed, j + 1 may be in flight
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // block j visible to every warp
        if (o < H) {
          const int8_t* mine = ring + (j & 1) * slot_bytes + warp * G * wbk;
          const int8_t* rows[G];
#pragma unroll
          for (int g = 0; g < G; ++g) rows[g] = mine + g * wbk;
          accumulate_block<G, BITS, true>(rows, d_s, K, ids[j] * block_k,
                                          block_k, bc, lane, ids[j] < nbk_x,
                                          acc);
        }
        __syncthreads();  // slot j & 1 is free for block j + 2
      }
    } else if (o < H) {
      for (int j = 0; j < n; ++j) {
        const int kb = ids[j];
        const int8_t* rows[G];
#pragma unroll
        for (int g = 0; g < G; ++g)
          rows[g] = a.w_q + ((size_t)g * Hp + o) * row + (size_t)kb * wbk;
        accumulate_block<G, BITS, false>(rows, d_s, K, kb * block_k, block_k,
                                         bc, lane, kb < nbk_x, acc);
      }
    }
    if (o < H) {
#pragma unroll
      for (int m = 0; m < 4; ++m) delta_walk::warp_sum(acc[m]);
      // activation: lane bb finishes stream b0 + bb
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb) {
        if (bb == lane && bb < bc) {
          const size_t mb = (size_t)(b0 + bb) * 4 * H;
          const size_t hb = (size_t)(b0 + bb) * H + o;
          float m[4], sc[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            m[q] = a.m_prev[mb + q * H + o] + acc[q][bb];  // exact sums
            // GRU: M_hc dequantizes with the candidate row's scale
            const float s = a.scales[(G == 3 && q == 3 ? 2 : q) * Hp + o];
            sc[q] = __fadd_rn(a.b4[q * Hp + o], __fmul_rn(m[q], s));
            a.m_out[mb + q * H + o] = m[q];
          }
          if constexpr (G == 3) {
            const float r = lut_sigmoid(sc[0], a.act, a.lut);
            const float u = lut_sigmoid(sc[1], a.act, a.lut);
            const float c = lut_tanh(__fadd_rn(sc[2], __fmul_rn(r, sc[3])),
                                     a.act, a.lut);
            a.h_out[hb] = grid_round(
                __fadd_rn(__fmul_rn(__fsub_rn(1.0f, u), c),
                          __fmul_rn(u, a.s_prev[hb])),
                a.act);
          } else {
            const float gi = lut_sigmoid(sc[0], a.act, a.lut);
            const float gf = lut_sigmoid(sc[1], a.act, a.lut);
            const float gg = lut_tanh(sc[2], a.act, a.lut);
            const float go = lut_sigmoid(sc[3], a.act, a.lut);
            // the saturating Q8.8 cell state; on the grid, so lut_tanh's own
            // rounding onto it changes nothing
            const float c = grid_round(
                __fadd_rn(__fmul_rn(gf, a.s_prev[hb]), __fmul_rn(gi, gg)),
                a.act);
            a.c_out[hb] = c;
            a.h_out[hb] =
                grid_round(__fmul_rn(go, lut_tanh(c, a.act, a.lut)), a.act);
          }
        }
      }
    }
    __syncthreads();  // the next pass overwrites the staged deltas
  }
}

__global__ void act_grid_kernel(float* sig, float* tnh, int n, int lo_code,
                                Grid act, Grid lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = __fdiv_rn((float)(lo_code + i), act.scale);  // exact
  sig[i] = lut_sigmoid(x, act, lut);
  tnh[i] = lut_tanh(x, act, lut);
}

template <int G, int BITS, bool BUF>
int launch(StepArgs a, cudaStream_t stream) {
  const int wbk = BITS == 8 ? a.block_k : a.block_k / 2;
  const int row = BITS == 8 ? a.K : a.K / 2;
  // the ring copies 16 bytes a thread: row strides and block offsets in
  // multiples of 16 bytes
  if (BUF && (wbk % 16 || row % 16)) return (int)cudaErrorInvalidValue;
  const size_t ring = BUF ? 2 * (size_t)kWarps * G * wbk : 0;
  size_t smem = 0;
  const cudaError_t err = delta_walk::size_launch(
      delta_q8_kernel<G, BITS, BUF>, a.B, a.K, a.block_k, &a.chunk, &smem,
      ring);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.H + kWarps - 1) / kWarps);
  delta_q8_kernel<G, BITS, BUF><<<grid, kWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int G>
int dispatch(const StepArgs& a, int weight_bits, int buffered,
             void* stream) {
  if (a.B <= 0 || a.H <= 0) return 0;
  if (a.block_k % 4 || a.K % a.block_k || a.ip % a.block_k)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (weight_bits == 8)
    return buffered ? launch<G, 8, true>(a, s) : launch<G, 8, false>(a, s);
  if (weight_bits == 4)
    return buffered ? launch<G, 4, true>(a, s) : launch<G, 4, false>(a, s);
  return (int)cudaErrorInvalidValue;
}

StepArgs step_args(const void* w_q, const void* scales, const void* b4,
                   const void* m_prev, const void* s_prev, const void* dx,
                   const void* dh, void* m_out, void* h_out, void* c_out,
                   int B, int I, int H, int Hp, int K, int ip, int block_k,
                   float act_scale, float act_min, float act_max,
                   float lut_scale, float lut_min, float lut_max) {
  return StepArgs{(const int8_t*)w_q, (const float*)scales, (const float*)b4,
                  (const float*)m_prev, (const float*)s_prev,
                  (const float*)dx, (const float*)dh, (float*)m_out,
                  (float*)h_out, (float*)c_out, B, I, H, Hp, K, ip, block_k,
                  0, Grid{act_scale, act_min, act_max},
                  Grid{lut_scale, lut_min, lut_max}};
}

}  // namespace

// One int8 (weight_bits 8) or int4 (weight_bits 4) fused GRU layer step;
// buffered != 0 runs the double-buffered form (the same bits).
//   w_q int8 [3, Hp, K] or [3, Hp, K/2] (nibble-packed), scales f32 [3, Hp],
//   b4 f32 [4, Hp], m_prev/m_out f32 [B, 4H] (code domain), h_prev/h_out f32
//   [B, H], dx f32 [B, I], dh f32 [B, H]; contiguous, 16-byte aligned.
// Requires block_k % 4 == 0 and K % block_k == 0; buffered also needs row
// strides and block widths in bytes that are multiples of 16. Returns
// cudaGetLastError().
extern "C" int delta_q8_gru_step(
    const void* w_q, const void* scales, const void* b4, const void* m_prev,
    const void* h_prev, const void* dx, const void* dh, void* m_out,
    void* h_out, int B, int I, int H, int Hp, int K, int ip, int block_k,
    int weight_bits, int buffered, float act_scale, float act_min,
    float act_max, float lut_scale, float lut_min, float lut_max,
    void* stream) {
  return dispatch<3>(
      step_args(w_q, scales, b4, m_prev, h_prev, dx, dh, m_out, h_out,
                nullptr, B, I, H, Hp, K, ip, block_k, act_scale, act_min,
                act_max, lut_scale, lut_min, lut_max),
      weight_bits, buffered, stream);
}

// One int8 / int4 fused LSTM layer step; buffered != 0 runs the
// double-buffered form (the same bits).
//   w_q int8 [4, Hp, K] or [4, Hp, K/2], scales f32 [4, Hp], b4 f32 [4, Hp],
//   m_prev/m_out f32 [B, 4H] (code domain), c_prev/c_out/h_out f32 [B, H]
//   (the cell state on the Q8.8 grid), dx f32 [B, I], dh f32 [B, H];
//   contiguous, 16-byte aligned. Same requirements as delta_q8_gru_step.
extern "C" int delta_q8_lstm_step(
    const void* w_q, const void* scales, const void* b4, const void* m_prev,
    const void* c_prev, const void* dx, const void* dh, void* m_out,
    void* h_out, void* c_out, int B, int I, int H, int Hp, int K, int ip,
    int block_k, int weight_bits, int buffered, float act_scale,
    float act_min, float act_max, float lut_scale, float lut_min,
    float lut_max, void* stream) {
  return dispatch<4>(
      step_args(w_q, scales, b4, m_prev, c_prev, dx, dh, m_out, h_out, c_out,
                B, I, H, Hp, K, ip, block_k, act_scale, act_min, act_max,
                lut_scale, lut_min, lut_max),
      weight_bits, buffered, stream);
}

// The kernels' own activation stage over every point of the activation grid:
// sig[i] = lut(sigmoid(x)), tnh[i] = lut(tanh(x)) for x = (lo_code + i) /
// act_scale, i < n. Used to check the device's expf / tanhf exhaustively
// against the host's after the LUT rounding.
extern "C" int delta_q8_act_grid(void* sig, void* tnh, int n, int lo_code,
                                 float act_scale, float act_min,
                                 float act_max, float lut_scale,
                                 float lut_min, float lut_max, void* stream) {
  const Grid act{act_scale, act_min, act_max};
  const Grid lut{lut_scale, lut_min, lut_max};
  act_grid_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (float*)sig, (float*)tnh, n, lo_code, act, lut);
  return (int)cudaGetLastError();
}
