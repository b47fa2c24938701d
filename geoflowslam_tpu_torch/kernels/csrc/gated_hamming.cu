// Gated projection Hamming search for Hopper (sm_90a).
//
// Replaces the TPU kernel
// geoflowslam_tpu/ops/pallas_kernels.py::_gated_hamming_kernel (entry
// search_by_projection_pallas). Plain version beside it:
// geoflowslam_tpu_torch/ops/matching.py::gated_hamming_plain (the mask path
// of the reference's XLA branch), which this kernel matches exactly.
//
// For each query i: over all targets j with |dx|,|dy| <= radius_i, an octave
// offset level_j - level_i in [min_off, max_off], and both sides valid, the
// best and second-best 256-bit Hamming distance and the argbest. Ties go to
// the lowest target index (XLA top_k's order). With no candidate the
// outputs are (big, big, -1).
//
// What bounds it on the card: N*M gated pairs of 8 XOR+popc each, at most
// 2048 x 1000 on the main path, a few million integer operations; the
// [N, M] distance matrix is never written. One warp owns one query; a block
// of 8 warps stages 256 targets at a time (uv, level, valid and the 8
// packed words, word-major so that lanes read consecutive words) in shared
// memory and every warp of the block scans the tile, so each target is read
// from device memory once per block, not once per query. Lanes keep a
// running (best, second, argbest) over ascending target indices and a
// shuffle reduction merges them, lower index first on ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // queries per block
constexpr int kTile = 256;   // targets per shared-memory tile

__device__ __forceinline__ void merge(int& best, int& second, int& arg,
                                      int ob, int os, int oa) {
  // the other lane's candidate wins on a smaller distance, or on an equal
  // one with a lower index (a lane with no candidate holds big and -1 and
  // loses every comparison against a real distance)
  const bool other = (ob < best) || (ob == best && oa < arg && oa >= 0);
  if (other) {
    second = min(os, best);
    best = ob;
    arg = oa;
  } else {
    second = min(second, ob);
  }
}

__global__ void gated_hamming_kernel(
    const float* __restrict__ q_uv, const int* __restrict__ q_level,
    const uint8_t* __restrict__ q_valid, const uint32_t* __restrict__ q_desc,
    const float* __restrict__ q_radius, const float* __restrict__ t_uv,
    const int* __restrict__ t_level, const uint8_t* __restrict__ t_valid,
    const uint32_t* __restrict__ t_desc, int n, int m, int min_off,
    int max_off, int big, int* __restrict__ out_best,
    int* __restrict__ out_second, int* __restrict__ out_idx) {
  __shared__ uint32_t s_desc[8][kTile];
  __shared__ float s_x[kTile];
  __shared__ float s_y[kTile];
  __shared__ int s_level[kTile];
  __shared__ uint8_t s_ok[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool q_in = qi < n;
  const bool q_ok = q_in && q_valid[qi] != 0;

  float qx = 0.f, qy = 0.f, qr = 0.f;
  int ql = 0;
  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = 0u;
  if (q_ok) {
    qx = q_uv[2 * qi];
    qy = q_uv[2 * qi + 1];
    qr = q_radius[qi];
    ql = q_level[qi];
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = q_desc[8 * qi + w];
  }

  int best = big, second = big, arg = -1;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      const int tj = base + j;
      if (tj < m) {
        s_x[j] = t_uv[2 * tj];
        s_y[j] = t_uv[2 * tj + 1];
        s_level[j] = t_level[tj];
        s_ok[j] = t_valid[tj];
#pragma unroll
        for (int w = 0; w < 8; ++w) s_desc[w][j] = t_desc[8 * tj + w];
      } else {
        s_ok[j] = 0;
      }
    }
    __syncthreads();
    if (!q_ok) continue;
    for (int j = lane; j < kTile; j += 32) {
      if (!s_ok[j]) continue;
      const float adx = fabsf(__fsub_rn(qx, s_x[j]));
      const float ady = fabsf(__fsub_rn(qy, s_y[j]));
      const int dl = s_level[j] - ql;
      if (adx <= qr && ady <= qr && dl >= min_off && dl <= max_off) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(qd[w] ^ s_desc[w][j]);
        if (d < best) {
          second = best;
          best = d;
          arg = base + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xffffffffu, best, off);
    const int os = __shfl_down_sync(0xffffffffu, second, off);
    const int oa = __shfl_down_sync(0xffffffffu, arg, off);
    merge(best, second, arg, ob, os, oa);
  }
  if (lane == 0 && q_in) {
    out_best[qi] = best;
    out_second[qi] = second;
    out_idx[qi] = best < big ? arg : -1;
  }
}

}  // namespace

// Launches `reps` times back to back on `stream` (1 on every path; more only
// to time the kernel); returns the cudaError_t of the launch (0 = success).
extern "C" int gfs_gated_hamming(const float* q_uv, const int* q_level,
                                 const uint8_t* q_valid,
                                 const uint32_t* q_desc, const float* q_radius,
                                 const float* t_uv, const int* t_level,
                                 const uint8_t* t_valid,
                                 const uint32_t* t_desc, int n, int m,
                                 int min_off, int max_off, int big,
                                 int* out_best, int* out_second, int* out_idx,
                                 int reps, cudaStream_t stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((n + kWarps - 1) / kWarps);
  for (int rep = 0; rep < reps; ++rep)
    gated_hamming_kernel<<<grid, block, 0, stream>>>(
        q_uv, q_level, q_valid, q_desc, q_radius, t_uv, t_level, t_valid,
        t_desc, n, m, min_off, max_off, big, out_best, out_second, out_idx);
  return static_cast<int>(cudaGetLastError());
}
