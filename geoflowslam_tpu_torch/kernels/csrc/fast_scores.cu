// FAST-9 corner response at two thresholds for Hopper (sm_90a): one level per
// launch (fast_scores_kernel), and every level of a pyramid with the 3x3
// non-maximum suppression and the border mask in one launch
// (fast_nms_levels_kernel).
//
// Replaces the TPU kernel geoflowslam_tpu/ops/pallas_kernels.py::_fast_kernel
// (entry fast_scores_pallas). Plain versions beside it, which the kernels
// match bit for bit: geoflowslam_tpu_torch/ops/fast.py::fast_score_maps for
// the per-level kernel, ops/fast.py::fast_nms_levels_plain (fast_score_maps,
// nms3x3 and the border mask per level) for the fused one.
//
// What bounds it on the card: the fused launch reads 4 bytes and writes 8
// for each of the 0.95 M pixels of the 8-level x1.2 pyramid of 480x640,
// 11.4 MB or 3.4 us of HBM traffic, and does ~344 float32 and integer
// operations (16 ring terms of 17, four arc tests, the NMS) for each of the
// 0.80 M pixels inside the 16 px border, 0.28 G or 4.1 us at the card's 67
// TFLOP/s: operations, by a little. TMA and wgmma have nothing to do here:
// a tile is 2.5 KB and there is no matrix product.
//
// The design for this card:
// * The fused grid runs over the 32x8 tiles of all levels (3797 blocks on
//   the main path, where the coarsest level alone gives 102); a table in the
//   kernel's parameters (pointer, h, w, first tile, tiles per row, output
//   offset, per level) tells a block which level and tile it has.
// * A block stages its tile with a 4 px halo (3 for the ring, 1 for the NMS)
//   in shared memory, computes the raw scores of the tile plus 1 px at both
//   thresholds into two more shared tiles, then each thread suppresses its
//   own pixel against its eight neighbours there and applies the border
//   test. Raw scores never reach device memory. A neighbour outside the
//   image reads -inf; a pixel of the 3 px FAST border reads 0 and takes part
//   in the NMS as 0, as in the plain version. A tile that lies wholly inside
//   the border writes zeros and stages nothing.
// * Each thread keeps its four 16-bit ring masks and four running sums in
//   registers; every ring read is a shared-memory hit.
// * A warp stores one 128-byte row segment per map. Stores of 16 bytes a
//   thread would need four pixels a thread and rows whose starts are 16-byte
//   aligned; half of the main path's level widths are odd (533, 309, 257,
//   179), and the stores are not what bounds the kernel, so every level takes
//   the one path.
//
// Exactness: reads outside the image clamp to the edge (jnp.pad "edge" in
// the reference), the 16 ring terms are summed in ring order k = 0..15 with
// the same float32 operations as the plain version, the masks are uint32
// (only bits 0..23 of the folded arc test reach the result, so the plain
// version's signed shifts give the same answer), and the NMS is comparisons
// only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;    // ring radius
constexpr int kBX = 32;  // block width (one warp per row)
constexpr int kBY = 8;   // block height
constexpr int kTW = kBX + 2 * kR;
constexpr int kTH = kBY + 2 * kR;
// the fused kernel: image tile with a 4 px halo, score tiles with 1 px
constexpr int kHalo = kR + 1;
constexpr int kFW = kBX + 2 * kHalo;
constexpr int kFH = kBY + 2 * kHalo;
constexpr int kSW = kBX + 2;
constexpr int kSH = kBY + 2;
constexpr int kMaxLevels = 16;

__device__ __forceinline__ bool arc_ok(uint32_t bits) {
  // contiguous run >= 9 on the circular 16-ring by shift-AND folding
  const uint32_t m = bits | (bits << 16);
  uint32_t t = m & (m >> 1);
  t = t & (t >> 2);
  t = t & (t >> 4);
  t = t & (m >> 8);
  return (t & 0xFFFFu) != 0u;
}

// FAST-9 responses at two thresholds of the pixel at `centre`, inside a
// shared-memory tile of row stride kStride that holds its ring.
template <int kStride>
__device__ __forceinline__ void fast_two(const float* centre, float th_lo,
                                         float th_hi, float& s_lo,
                                         float& s_hi) {
  // Bresenham circle of radius 3, the ring order of ops/fast.py::_CIRCLE
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const float c = centre[0];
  uint32_t bright_lo = 0u, dark_lo = 0u, bright_hi = 0u, dark_hi = 0u;
  float sb_lo = 0.f, sd_lo = 0.f, sb_hi = 0.f, sd_hi = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float d = centre[dy[k] * kStride + dx[k]] - c;
    bright_lo |= static_cast<uint32_t>(d > th_lo) << k;
    dark_lo |= static_cast<uint32_t>(d < -th_lo) << k;
    bright_hi |= static_cast<uint32_t>(d > th_hi) << k;
    dark_hi |= static_cast<uint32_t>(d < -th_hi) << k;
    sb_lo = __fadd_rn(sb_lo, fmaxf(__fsub_rn(d, th_lo), 0.f));
    sd_lo = __fadd_rn(sd_lo, fmaxf(__fsub_rn(-d, th_lo), 0.f));
    sb_hi = __fadd_rn(sb_hi, fmaxf(__fsub_rn(d, th_hi), 0.f));
    sd_hi = __fadd_rn(sd_hi, fmaxf(__fsub_rn(-d, th_hi), 0.f));
  }
  s_lo = (arc_ok(bright_lo) ? sb_lo : 0.f) + (arc_ok(dark_lo) ? sd_lo : 0.f);
  s_hi = (arc_ok(bright_hi) ? sb_hi : 0.f) + (arc_ok(dark_hi) ? sd_hi : 0.f);
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

  float s_lo, s_hi;
  fast_two<kTW>(&tile[threadIdx.y + kR][threadIdx.x + kR], th_lo, th_hi, s_lo,
                s_hi);
  const bool inside = (y >= kR) && (y < h - kR) && (x >= kR) && (x < w - kR);
  out_lo[y * w + x] = inside ? s_lo : 0.f;
  out_hi[y * w + x] = inside ? s_hi : 0.f;
}

// One pyramid level of the fused launch.
struct FastLevel {
  const float* img;
  int h, w;
  int tile0;          // index of the level's first tile in the grid
  int tiles_x;        // tiles per row of tiles
  long long out_off;  // floats before the level's low-threshold map
};

struct FastTable {
  FastLevel lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ float nms_border(float (*s)[kSW], int sy,
                                            int sx, bool inb) {
  const float v = s[sy][sx];
  float m = fmaxf(fmaxf(s[sy - 1][sx - 1], s[sy - 1][sx]),
                  fmaxf(s[sy - 1][sx + 1], s[sy][sx - 1]));
  m = fmaxf(m, fmaxf(fmaxf(s[sy][sx + 1], s[sy + 1][sx - 1]),
                     fmaxf(s[sy + 1][sx], s[sy + 1][sx + 1])));
  return (inb && v >= m) ? v : 0.f;
}

// For every level l of the table, at out + out_off: the [h, w] map of the
// low threshold, then that of the high one, each
// where(inside `border`, nms3x3(fast score), 0).
__global__ void fast_nms_levels_kernel(const __grid_constant__ FastTable tab,
                                       float* __restrict__ out, float th_lo,
                                       float th_hi, int border) {
  __shared__ float tile[kFH][kFW];
  __shared__ float s_lo[kSH][kSW];
  __shared__ float s_hi[kSH][kSW];

  int l = 0;
  while (l + 1 < tab.n && static_cast<int>(blockIdx.x) >= tab.lv[l + 1].tile0)
    ++l;
  const FastLevel& L = tab.lv[l];
  const float* __restrict__ img = L.img;
  const int h = L.h, w = L.w;
  const int t = blockIdx.x - L.tile0;
  const int y0 = (t / L.tiles_x) * kBY;
  const int x0 = (t - (t / L.tiles_x) * L.tiles_x) * kBX;
  float* __restrict__ out_lo = out + L.out_off;
  float* __restrict__ out_hi = out_lo + static_cast<long long>(h) * w;

  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool in_image = x < w && y < h;

  // a tile with no pixel inside the border: zeros (the same for the block)
  if (y0 + kBY <= border || y0 >= h - border || x0 + kBX <= border ||
      x0 >= w - border) {
    if (in_image) {
      out_lo[y * w + x] = 0.f;
      out_hi[y * w + x] = 0.f;
    }
    return;
  }

  for (int i = tid; i < kFH * kFW; i += kBX * kBY) {
    const int ty = i / kFW;
    const int tx = i - ty * kFW;
    const int gy = min(max(y0 + ty - kHalo, 0), h - 1);
    const int gx = min(max(x0 + tx - kHalo, 0), w - 1);
    tile[ty][tx] = img[gy * w + gx];
  }
  __syncthreads();

  // raw scores of the tile plus 1 px: -inf outside the image, 0 on the 3 px
  // FAST border
  for (int i = tid; i < kSH * kSW; i += kBX * kBY) {
    const int sy = i / kSW;
    const int sx = i - sy * kSW;
    const int py = y0 + sy - 1;
    const int px = x0 + sx - 1;
    float lo, hi;
    if (py < 0 || py >= h || px < 0 || px >= w) {
      lo = hi = -INFINITY;
    } else if (py < kR || py >= h - kR || px < kR || px >= w - kR) {
      lo = hi = 0.f;
    } else {
      fast_two<kFW>(&tile[sy + kR][sx + kR], th_lo, th_hi, lo, hi);
    }
    s_lo[sy][sx] = lo;
    s_hi[sy][sx] = hi;
  }
  __syncthreads();

  if (!in_image) return;
  const bool inb = (y >= border) && (y < h - border) && (x >= border) &&
                   (x < w - border);
  const int sy = threadIdx.y + 1;
  const int sx = threadIdx.x + 1;
  out_lo[y * w + x] = nms_border(s_lo, sy, sx, inb);
  out_hi[y * w + x] = nms_border(s_hi, sy, sx, inb);
}

}  // namespace

// Launches `reps` times back to back on `stream` (1 on every path; more only
// to time the kernel); returns the cudaError_t of the launch (0 = success).
extern "C" int gfs_fast_scores(const float* img, float* out_lo, float* out_hi,
                               int h, int w, float th_lo, float th_hi,
                               int reps, cudaStream_t stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
  for (int rep = 0; rep < reps; ++rep)
    fast_scores_kernel<<<grid, block, 0, stream>>>(img, out_lo, out_hi, h, w,
                                                   th_lo, th_hi);
  return static_cast<int>(cudaGetLastError());
}

// The fused launch. imgs, hs, ws: host arrays over the n_levels levels
// (device pointers of the level images and their shapes). Level l's two maps
// are written at out + 2 * sum_{k<l} hs[k] * ws[k] floats, low threshold
// first. cudaErrorInvalidValue for more than 16 levels or an empty level.
extern "C" int gfs_fast_nms_levels(const float* const* imgs, const int* hs,
                                   const int* ws, int n_levels, float* out,
                                   float th_lo, float th_hi, int border,
                                   int reps, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || border < 0)
    return cudaErrorInvalidValue;
  FastTable tab = {};
  tab.n = n_levels;
  int tiles = 0;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return cudaErrorInvalidValue;
    const int tx = (ws[l] + kBX - 1) / kBX;
    const int ty = (hs[l] + kBY - 1) / kBY;
    tab.lv[l] = {imgs[l], hs[l], ws[l], tiles, tx, off};
    tiles += tx * ty;
    off += 2LL * hs[l] * ws[l];
  }
  const dim3 block(kBX, kBY);
  const dim3 grid(tiles);
  for (int rep = 0; rep < reps; ++rep)
    fast_nms_levels_kernel<<<grid, block, 0, stream>>>(tab, out, th_lo, th_hi,
                                                       border);
  return static_cast<int>(cudaGetLastError());
}
