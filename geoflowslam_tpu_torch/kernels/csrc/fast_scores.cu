// FAST-9 corner response at two thresholds in one pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel geoflowslam_tpu/ops/pallas_kernels.py::_fast_kernel
// (entry fast_scores_pallas). Plain version beside it:
// geoflowslam_tpu_torch/ops/fast.py::fast_score_maps, which this kernel
// matches bit for bit.
//
// What bounds it on the card: one 640x480 level is 1.2 MB in and 2.4 MB out,
// about a microsecond of HBM traffic; the 16 ring reads per pixel are the
// work. Each block stages its tile plus a 3 px halo in shared memory once,
// so every ring read after that is a shared-memory hit, and each thread
// keeps its four 16-bit ring masks and four running sums in registers. The
// pyramid's small levels leave most of the card idle: launch overhead, not
// the card, is what a level costs here.
//
// Exactness: reads outside the image clamp to the edge (jnp.pad "edge" in
// the reference), the 16 ring terms are summed in ring order k = 0..15 with
// the same float32 operations as the plain version, and the masks are
// uint32 (only bits 0..23 of the folded arc test reach the result, so the
// plain version's signed shifts give the same answer).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;    // ring radius
constexpr int kBX = 32;  // block width (one warp per row)
constexpr int kBY = 8;   // block height
constexpr int kTW = kBX + 2 * kR;
constexpr int kTH = kBY + 2 * kR;

__device__ __forceinline__ bool arc_ok(uint32_t bits) {
  // contiguous run >= 9 on the circular 16-ring by shift-AND folding
  const uint32_t m = bits | (bits << 16);
  uint32_t t = m & (m >> 1);
  t = t & (t >> 2);
  t = t & (t >> 4);
  t = t & (m >> 8);
  return (t & 0xFFFFu) != 0u;
}

__global__ void fast_scores_kernel(const float* __restrict__ img,
                                   float* __restrict__ out_lo,
                                   float* __restrict__ out_hi, int h, int w,
                                   float th_lo, float th_hi) {
  __shared__ float tile[kTH][kTW];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kTH * kTW;
       i += kBX * kBY) {
    const int ty = i / kTW;
    const int tx = i - ty * kTW;
    const int gy = min(max(y0 + ty - kR, 0), h - 1);
    const int gx = min(max(x0 + tx - kR, 0), w - 1);
    tile[ty][tx] = img[gy * w + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  // Bresenham circle of radius 3, the ring order of ops/fast.py::_CIRCLE
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

  const int cy = threadIdx.y + kR;
  const int cx = threadIdx.x + kR;
  const float c = tile[cy][cx];
  uint32_t bright_lo = 0u, dark_lo = 0u, bright_hi = 0u, dark_hi = 0u;
  float sb_lo = 0.f, sd_lo = 0.f, sb_hi = 0.f, sd_hi = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = tile[cy + dy[k]][cx + dx[k]] - c;
    bright_lo |= static_cast<uint32_t>(d > th_lo) << k;
    dark_lo |= static_cast<uint32_t>(d < -th_lo) << k;
    bright_hi |= static_cast<uint32_t>(d > th_hi) << k;
    dark_hi |= static_cast<uint32_t>(d < -th_hi) << k;
    sb_lo = __fadd_rn(sb_lo, fmaxf(__fsub_rn(d, th_lo), 0.f));
    sd_lo = __fadd_rn(sd_lo, fmaxf(__fsub_rn(-d, th_lo), 0.f));
    sb_hi = __fadd_rn(sb_hi, fmaxf(__fsub_rn(d, th_hi), 0.f));
    sd_hi = __fadd_rn(sd_hi, fmaxf(__fsub_rn(-d, th_hi), 0.f));
  }
  const bool inside = (y >= kR) && (y < h - kR) && (x >= kR) && (x < w - kR);
  const float s_lo = (arc_ok(bright_lo) ? sb_lo : 0.f) +
                     (arc_ok(dark_lo) ? sd_lo : 0.f);
  const float s_hi = (arc_ok(bright_hi) ? sb_hi : 0.f) +
                     (arc_ok(dark_hi) ? sd_hi : 0.f);
  out_lo[y * w + x] = inside ? s_lo : 0.f;
  out_hi[y * w + x] = inside ? s_hi : 0.f;
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int gfs_fast_scores(const float* img, float* out_lo, float* out_hi,
                               int h, int w, float th_lo, float th_hi,
                               cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  fast_scores_kernel<<<grid, block, 0, stream>>>(img, out_lo, out_hi, h, w,
                                                 th_lo, th_hi);
  return static_cast<int>(cudaGetLastError());
}
