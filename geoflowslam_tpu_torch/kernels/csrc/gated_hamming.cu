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
// What bounds it on the card: almost nothing of the work. At 2048 x 1000
// the gate lets ~570 of 2.05 M pairs through, so the popcounts are a
// rounding error and the gate itself is 13 operations a pair, 0.0004 ms at
// the float32 rate. What one call costs is the launch and the trips to
// memory inside it: on an H100 this kernel reads 0.0054 ms at 2048 x 1000
// and 0.0027 ms at N = M = 8, the floor of one launch by the same event
// method (PERF.md). The searches of a frame cannot share a launch: each one
// projects from the pose or the map points that the one before it
// produced. So the design takes the trips out:
// - one staging pass: a block copies the gate fields of the whole target
//   set (x, y, level, valid) into shared memory as one 16-byte record a
//   target, with 16-byte loads where the arrays are aligned, behind one
//   __syncthreads (a tile loop only for M beyond kStage targets);
// - no descriptors staged: a lane whose pair passes the gate reads that
//   target's 32 bytes with two 16-byte loads from L2, ~0.3 times a query;
// - a block of 16 warps, one query a warp, its lanes scanning the records:
//   of the shapes timed on an H100 (4 to 32 warps, 1 to 4 queries a warp)
//   the fastest at 2048 x 1000; more queries a warp restage less but leave
//   SMs idle and lose (PERF.md);
// - (distance, index) packed into one key, (d << 23) | j, so the running
//   best and second are three unsigned min/max operations a pair and the
//   lanes merge in any order with the lower index winning ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;   // warps a block
constexpr int kStage = 2048;   // records a block holds (32 KB)
constexpr int kIdxBits = 23;   // targets < 2^23
constexpr uint32_t kIdxMask = (1u << kIdxBits) - 1u;
constexpr uint32_t kNone = 0xffffffffu;

__device__ __forceinline__ void push(uint32_t& best, uint32_t& second,
                                     uint32_t key) {
  second = min(second, max(best, key));
  best = min(best, key);
}

// records [0, cnt) of targets [base, base + cnt): (x, y, level, valid)
__device__ __forceinline__ void stage(float4* rec, const float* t_uv,
                                      const int* t_level,
                                      const uint8_t* t_valid, int base,
                                      int cnt) {
  const bool vec = ((reinterpret_cast<uintptr_t>(t_uv) |
                     reinterpret_cast<uintptr_t>(t_level)) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(t_valid) & 3u) == 0;
  const int n4 = vec ? cnt >> 2 : 0;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const int j = base + 4 * i;
    const float4 uv0 = __ldg(reinterpret_cast<const float4*>(t_uv + 2 * j));
    const float4 uv1 =
        __ldg(reinterpret_cast<const float4*>(t_uv + 2 * j + 4));
    const int4 lv = __ldg(reinterpret_cast<const int4*>(t_level + j));
    const uchar4 ok = *reinterpret_cast<const uchar4*>(t_valid + j);
    rec[4 * i] = make_float4(uv0.x, uv0.y, __int_as_float(lv.x),
                             __int_as_float(ok.x));
    rec[4 * i + 1] = make_float4(uv0.z, uv0.w, __int_as_float(lv.y),
                                 __int_as_float(ok.y));
    rec[4 * i + 2] = make_float4(uv1.x, uv1.y, __int_as_float(lv.z),
                                 __int_as_float(ok.z));
    rec[4 * i + 3] = make_float4(uv1.z, uv1.w, __int_as_float(lv.w),
                                 __int_as_float(ok.w));
  }
  for (int i = 4 * n4 + threadIdx.x; i < cnt; i += blockDim.x) {
    const int j = base + i;
    rec[i] = make_float4(t_uv[2 * j], t_uv[2 * j + 1],
                         __int_as_float(t_level[j]),
                         __int_as_float(static_cast<int>(t_valid[j])));
  }
}

__global__ void __launch_bounds__(kWarps * 32) gated_hamming_kernel(
    const float* __restrict__ q_uv, const int* __restrict__ q_level,
    const uint8_t* __restrict__ q_valid, const uint32_t* __restrict__ q_desc,
    const float* __restrict__ q_radius, const float* __restrict__ t_uv,
    const int* __restrict__ t_level, const uint8_t* __restrict__ t_valid,
    const uint32_t* __restrict__ t_desc, int n, int m, int min_off,
    int max_off, int big, int* __restrict__ out) {
  extern __shared__ float4 s_rec[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool active = qi < n && q_valid[qi];

  uint32_t best = kNone, second = kNone;
  float qx = 0.f, qy = 0.f, qr = 0.f;
  int ql = 0;
  uint4 qd0 = make_uint4(0u, 0u, 0u, 0u), qd1 = qd0;
  if (active) {
    qx = q_uv[2 * qi];
    qy = q_uv[2 * qi + 1];
    qr = q_radius[qi];
    ql = q_level[qi];
    const uint4* qd = reinterpret_cast<const uint4*>(q_desc + 8 * qi);
    qd0 = __ldg(qd);
    qd1 = __ldg(qd + 1);
  }

  for (int base = 0; base < m; base += kStage) {
    const int cnt = min(kStage, m - base);
    if (base > 0) __syncthreads();
    stage(s_rec, t_uv, t_level, t_valid, base, cnt);
    __syncthreads();
    if (!active) continue;
    for (int j = lane; j < cnt; j += 32) {
      const float4 r = s_rec[j];
      const float adx = fabsf(__fsub_rn(qx, r.x));
      const float ady = fabsf(__fsub_rn(qy, r.y));
      const int dl = __float_as_int(r.z) - ql;
      if (__float_as_int(r.w) != 0 && adx <= qr && ady <= qr &&
          dl >= min_off && dl <= max_off) {
        const uint4* td =
            reinterpret_cast<const uint4*>(t_desc + 8 * (base + j));
        const uint4 t0 = __ldg(td), t1 = __ldg(td + 1);
        const uint32_t d =
            __popc(qd0.x ^ t0.x) + __popc(qd0.y ^ t0.y) +
            __popc(qd0.z ^ t0.z) + __popc(qd0.w ^ t0.w) +
            __popc(qd1.x ^ t1.x) + __popc(qd1.y ^ t1.y) +
            __popc(qd1.z ^ t1.z) + __popc(qd1.w ^ t1.w);
        push(best, second,
             (d << kIdxBits) | static_cast<uint32_t>(base + j));
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t ob = __shfl_xor_sync(0xffffffffu, best, off);
    const uint32_t os = __shfl_xor_sync(0xffffffffu, second, off);
    second = min(min(second, os), max(best, ob));
    best = min(best, ob);
  }
  if (lane == 0 && qi < n) {
    const uint32_t bd = best >> kIdxBits, sd = second >> kIdxBits;
    const bool has = bd <= 256u;
    out[qi] = has ? static_cast<int>(bd) : big;
    out[n + qi] = sd <= 256u ? static_cast<int>(sd) : big;
    out[2 * n + qi] = has ? static_cast<int>(best & kIdxMask) : -1;
  }
}

}  // namespace

// Launches `reps` times back to back on `stream` (1 on every path; more only
// to time the kernel); out is [3, n] int32 (best, second, idx). Returns the
// cudaError_t of the launch (0 = success); cudaErrorInvalidValue for sizes
// the kernel does not take.
extern "C" int gfs_gated_hamming(const float* q_uv, const int* q_level,
                                 const uint8_t* q_valid,
                                 const uint32_t* q_desc, const float* q_radius,
                                 const float* t_uv, const int* t_level,
                                 const uint8_t* t_valid,
                                 const uint32_t* t_desc, int n, int m,
                                 int min_off, int max_off, int big, int* out,
                                 int reps, cudaStream_t stream) {
  if (n < 0 || m < 0 || m > static_cast<int>(kIdxMask))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const dim3 grid((n + kWarps - 1) / kWarps);
  const int staged = m < kStage ? m : kStage;
  const size_t smem = sizeof(float4) * static_cast<size_t>(staged);
  for (int rep = 0; rep < reps; ++rep)
    gated_hamming_kernel<<<grid, kWarps * 32, smem, stream>>>(
        q_uv, q_level, q_valid, q_desc, q_radius, t_uv, t_level, t_valid,
        t_desc, n, m, min_off, max_off, big, out);
  return static_cast<int>(cudaGetLastError());
}
