// Ungated best-two Hamming search for Hopper (sm_90a).
//
// Replaces the TPU kernel
// geoflowslam_tpu/ops/pallas_kernels.py::_hamming_argmin2_kernel (entry
// hamming_argmin2_pallas), which is the unmasked body of
// geoflowslam_tpu/ops/matching.py::match_descriptors. Plain version beside
// it: geoflowslam_tpu_torch/ops/matching.py::hamming_best2_plain, which this
// kernel matches exactly.
//
// For each query i over all targets j: the distance is the 256-bit Hamming
// distance when both q_valid[i] and t_valid[j] are set, else `big`. Outputs
// the best and second-best distance and the argbest, ties to the lowest
// target index (XLA top_k's and argmin's order). A row with no valid pair
// reads (big, big, 0), as top_k and argmin over an all-`big` row give index
// 0. The mutual check of match_descriptors is a second launch with the two
// sides swapped, of which only the argbest is read.
//
// What bounds it on the card: N*M pairs of 8 XOR+popc each, 1000 x 1000 on
// the relocalization and loop-verification paths, a few tens of millions of
// integer operations; the [N, M] distance matrix is never written. The TPU
// kernel computed the distances as a +-1 bf16 matmul on the MXU; here the
// integer units do it directly. One warp owns one query; a block of 8 warps
// stages 256 targets at a time (the 8 packed words, word-major so that
// lanes read consecutive words without bank conflicts, and the validity
// flags) in shared memory and every warp of the block scans the tile, so a
// target is read from device memory once per block, not once per query.
// Each lane keeps a running (best, second, argbest) over ascending target
// indices; a shuffle reduction merges the lanes, lower (distance, index)
// first, the loser's best feeding the winner's second.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // queries per block
constexpr int kTile = 256;   // targets per shared-memory tile

__device__ __forceinline__ void merge(int& best, int& second, int& arg,
                                      int ob, int os, int oa) {
  // lanes without a candidate hold (big, big, INT_MAX) and lose every
  // comparison against a real one
  if (ob < best || (ob == best && oa < arg)) {
    second = min(os, best);
    best = ob;
    arg = oa;
  } else {
    second = min(second, ob);
  }
}

__global__ void hamming_best2_kernel(const uint32_t* __restrict__ q_desc,
                                     const uint8_t* __restrict__ q_valid,
                                     const uint32_t* __restrict__ t_desc,
                                     const uint8_t* __restrict__ t_valid,
                                     int n, int m, int big,
                                     int* __restrict__ out_best,
                                     int* __restrict__ out_second,
                                     int* __restrict__ out_idx) {
  __shared__ uint32_t s_desc[8][kTile];
  __shared__ uint8_t s_ok[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool q_in = qi < n;
  const bool q_ok = q_in && q_valid[qi] != 0;

  uint32_t qd[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) qd[w] = q_ok ? q_desc[8 * qi + w] : 0u;

  int best = big, second = big, arg = INT_MAX;
  for (int base = 0; base < m; base += kTile) {
    __syncthreads();
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      const int tj = base + j;
      if (tj < m) {
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
    out_idx[qi] = best < big ? arg : 0;
  }
}

}  // namespace

// Launches `reps` times back to back on `stream` (1 on every path; more only
// to time the kernel); returns the cudaError_t of the launch (0 = success).
extern "C" int gfs_hamming_best2(const uint32_t* q_desc,
                                 const uint8_t* q_valid,
                                 const uint32_t* t_desc,
                                 const uint8_t* t_valid, int n, int m,
                                 int big, int* out_best, int* out_second,
                                 int* out_idx, int reps,
                                 cudaStream_t stream) {
  const dim3 block(32 * kWarps);
  const dim3 grid((n + kWarps - 1) / kWarps);
  for (int rep = 0; rep < reps; ++rep)
    hamming_best2_kernel<<<grid, block, 0, stream>>>(
        q_desc, q_valid, t_desc, t_valid, n, m, big, out_best, out_second,
        out_idx);
  return static_cast<int>(cudaGetLastError());
}
