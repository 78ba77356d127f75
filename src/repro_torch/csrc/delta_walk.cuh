// The prologue every fused delta kernel runs (csrc/delta_q8.cu,
// delta_step_f32.cuh, delta_spmv.cu): stage the concatenated deltas
// [dx | 0 | dh | 0] of a chunk of streams in shared memory with each
// thread's loads issued before any store, mark the nonzero 16-byte slots by
// warp vote, and, after the one barrier, let each warp compact the ids of
// the fired block_k column blocks itself by ballot and popcount. No thread
// walks the blocks alone and no CUDA API call is made on a launch: the
// kernels take their launch plans from the host.
#pragma once

#include <cuda_runtime.h>

namespace delta_walk {

constexpr int kMaxB = 8;  // streams per pass of a tile instance

// Staged deltas keep 4 floats of padding after every 16 columns: eight lanes
// that read 16 bytes each from eight neighbouring 16-column segments then
// fall on eight different groups of banks.
__host__ __device__ __forceinline__ int dpos(int c) {
  return c + ((c >> 4) << 2);
}

// Floats one staged stream takes (a multiple of 4, so every row of the
// staged tile stays 16-byte aligned).
__host__ __device__ __forceinline__ int kpad(int K) {
  return K + ((K + 15) >> 4) * 4;
}

// A bf16 value (its 16 bits) as the float it is, exactly.
__device__ __forceinline__ float bf16_bits_to_f32(unsigned bits) {
  return __uint_as_float(bits << 16);
}

// Four deltas from src (lim of them real, the rest zero): one 16-byte
// (float) or 8-byte (bf16 bits, uint16_t) load when vec, else one at a time.
template <typename TD>
__device__ __forceinline__ float4 load_deltas4(const TD* src, int lim,
                                               bool vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (sizeof(TD) == 4) {
    if (vec && lim >= 4) {
      v = __ldg(reinterpret_cast<const float4*>(src));
    } else if (lim > 0) {
      v.x = __ldg(src);
      if (lim > 1) v.y = __ldg(src + 1);
      if (lim > 2) v.z = __ldg(src + 2);
      if (lim > 3) v.w = __ldg(src + 3);
    }
  } else {
    if (vec && lim >= 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
      v = make_float4(bf16_bits_to_f32(u.x & 0xffffu),
                      bf16_bits_to_f32(u.x >> 16),
                      bf16_bits_to_f32(u.y & 0xffffu),
                      bf16_bits_to_f32(u.y >> 16));
    } else if (lim > 0) {
      v.x = bf16_bits_to_f32(__ldg(src));
      if (lim > 1) v.y = bf16_bits_to_f32(__ldg(src + 1));
      if (lim > 2) v.z = bf16_bits_to_f32(__ldg(src + 2));
      if (lim > 3) v.w = bf16_bits_to_f32(__ldg(src + 3));
    }
  }
  return v;
}

// Stage [dx | 0 | dh | 0] of streams b0 .. b0 + bc - 1 into d_s [bc][kpad(K)]
// (column c at dpos(c)) as 16-byte float4 slots, and write for every 32
// slots of the flattened [bc][K/4] slot space one word of vmask whose bit l
// says that slot 32w + l holds a nonzero delta (a warp vote, no shared store
// per thread). Each thread issues the loads of NL slots before it uses any of
// them. Every thread of the block calls it (blockDim.x a multiple of 32);
// there is no barrier inside: the caller syncs before reading d_s or vmask.
// TD is the deltas' element type: float, or uint16_t holding bf16 bits
// (staged as the floats they are). Requires K % 4 == 0 and ip % 4 == 0; rows
// of dx (dh) load 4 elements at once when I (H) is a multiple of 4, else one
// at a time.
template <int NL, typename TD = float>
__device__ __forceinline__ void stage_deltas(
    const TD* __restrict__ dx, const TD* __restrict__ dh, float* d_s,
    unsigned* vmask, int b0, int bc, int I, int H, int K, int ip) {
  const int k4 = K >> 2;
  const int total = bc * k4;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int stride = kpad(K);
  const bool vec_x = (I & 3) == 0, vec_h = (H & 3) == 0;
  for (int base = 0; base < total; base += NL * nt) {  // uniform in the block
    float4 v[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int s = base + i * nt + tid;
      v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (s < total) {
        const int bb = bc == 1 ? 0 : s / k4;
        const int k = (s - bb * k4) << 2;
        if (k < ip)
          v[i] = load_deltas4(dx + (size_t)(b0 + bb) * I + k, I - k, vec_x);
        else
          v[i] = load_deltas4(dh + (size_t)(b0 + bb) * H + (k - ip),
                              H - (k - ip), vec_h);
      }
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int s = base + i * nt + tid;
      const bool nz = v[i].x != 0.0f || v[i].y != 0.0f || v[i].z != 0.0f ||
                      v[i].w != 0.0f;
      const unsigned bits = __ballot_sync(0xffffffffu, nz);
      if (s < total) {
        const int bb = bc == 1 ? 0 : s / k4;
        const int k = (s - bb * k4) << 2;
        *reinterpret_cast<float4*>(d_s + bb * stride + dpos(k)) = v[i];
      }
      const int s0 = s - (tid & 31);  // this warp's first slot
      if ((tid & 31) == 0 && s0 < total) vmask[s0 >> 5] = bits;
    }
  }
}

// Whether any of bits a .. a + n - 1 of vmask is set.
__device__ __forceinline__ bool any_bit(const unsigned* vmask, int a, int n) {
  const int end = a + n;
  for (int w = a >> 5; w <= (end - 1) >> 5; ++w) {
    const int lo = max(a - (w << 5), 0);
    const int hi = min(end - (w << 5), 32);
    const unsigned keep =
        (hi == 32 ? 0xffffffffu : (1u << hi) - 1u) & ~((1u << lo) - 1u);
    if (vmask[w] & keep) return true;
  }
  return false;
}

// This warp's list of the block_k column blocks j_lo .. j_hi - 1 (all of
// them by default) that any of the bc staged streams fired, in increasing
// order, compacted by ballot and popcount 32 blocks at a time into
// ids[0 .. n). Returns n (the same in every lane). Every lane of the warp
// calls it after the barrier that follows stage_deltas; it ends with
// __syncwarp, so ids is visible to the warp.
__device__ __forceinline__ int warp_fired_blocks(const unsigned* vmask,
                                                 int* ids, int bc, int K,
                                                 int block_k, int lane,
                                                 int j_lo = 0, int j_hi = -1) {
  const int nbk = j_hi < 0 ? K / block_k : j_hi, k4 = K >> 2;
  const int bk4 = block_k >> 2;
  int n = 0;
  for (int j0 = j_lo; j0 < nbk; j0 += 32) {
    const int j = j0 + lane;
    bool fired = false;
    if (j < nbk)
      for (int bb = 0; bb < bc && !fired; ++bb)
        fired = any_bit(vmask, bb * k4 + j * bk4, bk4);
    const unsigned m = __ballot_sync(0xffffffffu, fired);
    if (fired) ids[n + __popc(m & ((1u << lane) - 1u))] = j;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

}  // namespace delta_walk
