// Lucas-Kanade optical flow for N points, for Hopper (sm_90a): one pyramid
// level per launch (lk_level_kernel), and the whole forward-backward,
// coarse-to-fine track of several streams in one launch (lk_pyramid_kernel).
//
// Replaces the TPU kernel geoflowslam_tpu/ops/pallas_kernels.py::
// _lk_level_kernel (entry lk_level_pallas). It is held against the XLA
// formulation geoflowslam_tpu/ops/klt.py::_track_level, whose port is the
// plain version beside it: geoflowslam_tpu_torch/ops/klt.py::_track_level,
// and, for the fused launch, ops/klt.py::fb_klt_track called once per
// stream. The Pallas kernel's one-hot band matmuls and its residual-shift
// clamp at win >= 23 are TPU workarounds and are not carried over.
//
// Per point and level: a bilinear (win+2)^2 template around pts (from a
// (win+3)^2 block of the edge-padded previous level), central-difference
// gradients of its inner win^2, the structure tensor and its
// minimum-eigenvalue gate, then `iters` Gauss-Newton steps, each resampling
// a bilinear win^2 patch of the next level at the current estimate; finally
// (x, y, ok, mean |residual|).
//
// What bounds it on the card: operations, not bytes. A point-level at win
// 21 and 10 iterations is 11 passes of 441 samples, ~65 kflop; the fused
// launch of the main path (2 streams x 1256 points, 3 + 1 and 4 + 1 levels)
// is 11 304 point-levels, 0.73 GFLOP, 11 us at the card's 67 TFLOP/s
// float32 peak, against 1 us for reading both four-level pyramids once
// (1.6 MB each; they stay in the 50 MB L2). TMA and wgmma have nothing to do
// here: the reads are per-point gathers whose address depends on the
// current estimate, and there is no matrix product.
//
// The design for this card:
// * One warp owns one (stream, point) from the top level to the end of the
//   backward pass. The current estimate, ok and err live in registers
//   between levels, the level factors are applied in the kernel, and the
//   forward-backward gate is taken at the end: one launch per frame where
//   the per-level kernel needs nine, and 2 x 1256 warps where one level
//   gives 1256 (the card holds 8448).
// * The two pyramids reach the kernel as a table in its parameters
//   (pointers, h, w and the float32 level factor, up to 8 levels).
// * Per level the warp builds its (win+2)^2 template in shared memory and
//   stores the two win^2 gradient planes beside it once, so the
//   Gauss-Newton passes read them and do not recompute them (1411 floats a
//   warp at win 21). A window whose planes do not fit in the block's 227 KB
//   (win > 138) recomputes the gradients from the template at every pass, in
//   this kernel (template only: any win up to 239).
// * Each lane takes every 32nd sample of the window and carries its (row,
//   column) along by a fixed step (32 / win rows and 32 % win columns, one
//   conditional wrap), so no sample pays an integer division and
//   neighbouring lanes read neighbouring texels. The four texels of a
//   bilinear sample share two clamped rows and two clamped columns.
// * The five per-point sums (structure tensor, the two GN right-hand sides,
//   |residual|) are butterfly shuffle reductions; every lane holds the same
//   bits afterwards, so the warp never diverges on the estimate.
//
// Semantics kept from the reference:
// * Block starts are placed as jax.lax.dynamic_slice places them, not
//   padded: a negative start counts from the end of the axis (once), then
//   the start is clamped into [0, padded_dim - side]. A point near or past
//   the border thus reads a shifted block of the edge-padded image, and one
//   left of or above it a block from the opposite side. Texel (y, x) of the
//   padded image is image (clamp(y - pad), clamp(x - pad)).
// * floor(g) is clamped to +-2^20 (NaN to 0) before the int cast; any value
//   beyond the padded image gives the same clamped block start, and the
//   cast is never out of range.
// * Elementwise arithmetic uses explicit round-to-nearest intrinsics in the
//   plain version's operation order (no FMA contraction), so each sample,
//   template value and gradient equals the plain version's bit for bit, and
//   the level factors are the float32 values the plain version multiplies
//   by; only the order of the per-point sums differs (and, in the fused
//   launch, the rounding of the forward-backward distance's two-term sum).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsMax = 4;            // points per block
constexpr float kIndexBound = 1048576.f;  // 2^20
constexpr int kSmemMax = 232448;        // dynamic shared memory per block
constexpr int kMaxLevels = 8;           // pyramid levels in the table
constexpr int kMaxStreams = 4;

// Floats of shared memory one warp needs at window `win`: its (win+2)^2
// template and, with `planes`, the two win^2 gradient planes.
__host__ __device__ constexpr int warp_floats(int win, bool planes) {
  return (win + 2) * (win + 2) + (planes ? 2 * win * win : 0);
}

__device__ __forceinline__ int floor_index(float v) {
  float f = floorf(v);
  if (f != f) f = 0.f;
  f = fminf(fmaxf(f, -kIndexBound), kIndexBound);
  return static_cast<int>(f);
}

// Bilinear sample with top-left texel (y, x) of the unpadded image and the
// four weights; the plain version's ((w00 p00 + w01 p01) + w10 p10) + w11 p11.
__device__ __forceinline__ float blend(const float* __restrict__ img, int h,
                                       int w, int y, int x, float w00,
                                       float w01, float w10, float w11) {
  const float* r0 = img + min(max(y, 0), h - 1) * w;
  const float* r1 = img + min(max(y + 1, 0), h - 1) * w;
  const int x0 = min(max(x, 0), w - 1);
  const int x1 = min(max(x + 1, 0), w - 1);
  const float a = __fmul_rn(w00, __ldg(r0 + x0));
  const float b = __fmul_rn(w01, __ldg(r0 + x1));
  const float c = __fmul_rn(w10, __ldg(r1 + x0));
  const float d = __fmul_rn(w11, __ldg(r1 + x1));
  return __fadd_rn(__fadd_rn(__fadd_rn(a, b), c), d);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Start (in unpadded image coordinates) of the block of `side` texels whose
// padded-image start is base + offset, placed as dynamic_slice places it.
__device__ __forceinline__ int block_start(int base, int offset, int pad,
                                           int padded_dim, int side) {
  int s = base + offset + pad;
  if (s < 0) s += padded_dim;
  s = min(max(s, 0), padded_dim - side);
  return s - pad;
}

struct Weights {
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Weights weights(float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  return {__fmul_rn(gx, gy), __fmul_rn(fx, gy), __fmul_rn(gx, fy),
          __fmul_rn(fx, fy)};
}

// A lane's walk over a width x width window, every 32nd sample in row-major
// order, without a division per sample: (row, col) of sample lane + 32 j.
struct Walk {
  int row0, col0, drow, dcol, width;
  __device__ Walk(int lane, int width_)
      : row0(lane / width_), col0(lane % width_), drow(32 / width_),
        dcol(32 % width_), width(width_) {}
  __device__ __forceinline__ void step(int& row, int& col) const {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// One level of LK for the warp's point. (px, py): the point in the level's
// coordinates; (gx, gy): the estimate, updated in place. `sm` is the warp's
// shared memory: the template, then (kPlanes) the two gradient planes.
// Returns ok (min-eigenvalue gate and estimate inside the image); err is the
// mean |residual| at the final estimate. Every lane returns the same values.
template <bool kPlanes>
__device__ __forceinline__ bool track_level(
    const float* __restrict__ prev, const float* __restrict__ next, int h,
    int w, float px, float py, float& gx, float& gy, int win, int iters,
    float min_eig, float* sm, int lane, const Walk& wt_walk,
    const Walk& win_walk, float& err) {
  const int r = win / 2;
  const int pad = r + 2;
  const int hp = h + 2 * pad;
  const int wp = w + 2 * pad;
  const int side = win + 2;  // template side: offsets -(r+1) .. -(r+1)+win+1
  const int nt = side * side;
  const int nw = win * win;
  float* tm = sm;
  float* pix = sm + nt;       // gradient planes (kPlanes only)
  float* piy = pix + nw;

  __syncwarp();  // the previous level's reads of this memory are over

  // ---- template: bilinear (win+2)^2 samples around the point --------------
  {
    const Weights wt = weights(__fsub_rn(px, floorf(px)),
                               __fsub_rn(py, floorf(py)));
    const int ty = block_start(floor_index(py), -(r + 1), pad, hp, win + 3);
    const int tx = block_start(floor_index(px), -(r + 1), pad, wp, win + 3);
    int a = wt_walk.row0, b = wt_walk.col0;
    for (int k = lane; k < nt; k += 32) {
      tm[k] = blend(prev, h, w, ty + a, tx + b, wt.w00, wt.w01, wt.w10,
                    wt.w11);
      wt_walk.step(a, b);
    }
  }
  __syncwarp();

  // ---- gradients and structure tensor over the inner win^2 ----------------
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  {
    int a = win_walk.row0, b = win_walk.col0;
    for (int k = lane; k < nw; k += 32) {
      const float* row = tm + (a + 1) * side + (b + 1);
      const float ix = __fmul_rn(0.5f, __fsub_rn(row[1], row[-1]));
      const float iy = __fmul_rn(0.5f, __fsub_rn(row[side], row[-side]));
      if (kPlanes) {
        pix[k] = ix;
        piy[k] = iy;
      }
      gxx = __fadd_rn(gxx, __fmul_rn(ix, ix));
      gxy = __fadd_rn(gxy, __fmul_rn(ix, iy));
      gyy = __fadd_rn(gyy, __fmul_rn(iy, iy));
      win_walk.step(a, b);
    }
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = __fsub_rn(__fmul_rn(gxx, gyy), __fmul_rn(gxy, gxy));
  const float tr = __fadd_rn(gxx, gyy);
  const float disc = fmaxf(__fsub_rn(__fmul_rn(tr, tr), __fmul_rn(4.f, det)),
                           0.f);
  const float eig_min = __fmul_rn(0.5f, __fsub_rn(tr, __fsqrt_rn(disc)));
  const bool good = __fdiv_rn(eig_min, static_cast<float>(nw)) > min_eig;
  const float det_safe = fabsf(det) < 1e-9f ? 1e-9f : det;

  // ---- Gauss-Newton on the next level -------------------------------------
  float abs_sum = 0.f;
  for (int it = 0; it <= iters; ++it) {
    const Weights wc = weights(__fsub_rn(gx, floorf(gx)),
                               __fsub_rn(gy, floorf(gy)));
    const int cy = block_start(floor_index(gy), -r, pad, hp, win + 1);
    const int cx = block_start(floor_index(gx), -r, pad, wp, win + 1);
    float bx = 0.f, by = 0.f;
    int a = win_walk.row0, b = win_walk.col0;
    if (it == iters) {  // the last pass only measures the residual
#pragma unroll 4
      for (int k = lane; k < nw; k += 32) {
        const float di = __fsub_rn(
            blend(next, h, w, cy + a, cx + b, wc.w00, wc.w01, wc.w10, wc.w11),
            tm[(a + 1) * side + (b + 1)]);
        abs_sum = __fadd_rn(abs_sum, fabsf(di));
        win_walk.step(a, b);
      }
      break;
    }
#pragma unroll 4
    for (int k = lane; k < nw; k += 32) {
      const float* row = tm + (a + 1) * side + (b + 1);
      const float di = __fsub_rn(
          blend(next, h, w, cy + a, cx + b, wc.w00, wc.w01, wc.w10, wc.w11),
          row[0]);
      float ix, iy;
      if (kPlanes) {
        ix = pix[k];
        iy = piy[k];
      } else {
        ix = __fmul_rn(0.5f, __fsub_rn(row[1], row[-1]));
        iy = __fmul_rn(0.5f, __fsub_rn(row[side], row[-side]));
      }
      bx = __fadd_rn(bx, __fmul_rn(di, ix));
      by = __fadd_rn(by, __fmul_rn(di, iy));
      win_walk.step(a, b);
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    const float sx = __fdiv_rn(
        -__fsub_rn(__fmul_rn(gyy, bx), __fmul_rn(gxy, by)), det_safe);
    const float sy = __fdiv_rn(
        -__fadd_rn(__fmul_rn(-gxy, bx), __fmul_rn(gxx, by)), det_safe);
    if (good) {
      gx = __fadd_rn(gx, sx);
      gy = __fadd_rn(gy, sy);
    }
  }
  abs_sum = warp_sum(abs_sum);
  err = __fdiv_rn(abs_sum, static_cast<float>(nw));
  const bool inb = gx >= 0.f && gx <= static_cast<float>(w - 1) &&
                   gy >= 0.f && gy <= static_cast<float>(h - 1);
  return good && inb;
}

template <bool kPlanes>
__global__ void lk_level_kernel(const float* __restrict__ prev,
                                const float* __restrict__ next, int h, int w,
                                const float* __restrict__ pts,
                                const float* __restrict__ guess, int n,
                                int win, int iters, float min_eig,
                                float* __restrict__ out_pts,
                                uint8_t* __restrict__ out_ok,
                                float* __restrict__ out_err) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n) return;  // the whole warp leaves together; no block barrier
  float* sm = smem + warp * warp_floats(win, kPlanes);
  const Walk wt_walk(lane, win + 2), win_walk(lane, win);
  float gx = guess[2 * i];
  float gy = guess[2 * i + 1];
  float err;
  const bool ok = track_level<kPlanes>(prev, next, h, w, pts[2 * i],
                                       pts[2 * i + 1], gx, gy, win, iters,
                                       min_eig, sm, lane, wt_walk, win_walk,
                                       err);
  if (lane == 0) {
    out_pts[2 * i] = gx;
    out_pts[2 * i + 1] = gy;
    out_ok[i] = ok ? 1 : 0;
    out_err[i] = err;
  }
}

// The two pyramids and the streams of one fused launch.
struct LkLevel {
  const float* prev;
  const float* next;
  int h, w;
  float inv;  // float32(1 / scale^level): level-0 to level coordinates
};

struct LkTable {
  LkLevel lv[kMaxLevels];
  int levels[kMaxStreams];  // forward levels of each stream
  int n_streams;
  int fb_levels;  // backward levels (capped by the stream's own)
  float scale;    // float32(scale_factor): one level finer
  float fb_thresh;
};

// Forward-backward pyramidal LK for `tab.n_streams` streams of n points:
// pts, guess [S, n, 2] in level-0 coordinates -> out_pts [S, n, 2] (the
// forward estimate), out_status [S, n], out_err [S, n] (the forward pass's
// finest level).
template <bool kPlanes>
__global__ void lk_pyramid_kernel(const __grid_constant__ LkTable tab,
                                  const float* __restrict__ pts,
                                  const float* __restrict__ guess, int n,
                                  int win, int iters, float min_eig,
                                  float* __restrict__ out_pts,
                                  uint8_t* __restrict__ out_status,
                                  float* __restrict__ out_err) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;  // stream * n + point
  if (i >= tab.n_streams * n) return;  // the whole warp leaves together
  const int s = i / n;
  float* sm = smem + warp * warp_floats(win, kPlanes);
  const Walk wt_walk(lane, win + 2), win_walk(lane, win);

  const float px = pts[2 * i];
  const float py = pts[2 * i + 1];
  const int n_fwd = tab.levels[s];
  const int n_bwd = min(tab.fb_levels, n_fwd);

  // Forward, coarse to fine from the stream's own guess, then backward from
  // the forward estimate with the pyramids swapped: one loop over the
  // n_fwd + n_bwd levels, so that the level function is inlined once.
  float qx = px, qy = py;  // the tracked point, level-0 coordinates
  float gx = __fmul_rn(guess[2 * i], tab.lv[n_fwd - 1].inv);  // the estimate
  float gy = __fmul_rn(guess[2 * i + 1], tab.lv[n_fwd - 1].inv);
  float fx = 0.f, fy = 0.f, err = 0.f;  // the forward pass's result
  bool ok_all = true;
  for (int step = 0; step < n_fwd + n_bwd; ++step) {
    const bool back = step >= n_fwd;
    const int lvl = (back ? n_fwd + n_bwd : n_fwd) - 1 - step;
    if (step == n_fwd) {
      fx = qx = gx;
      fy = qy = gy;
      gx = __fmul_rn(fx, tab.lv[lvl].inv);
      gy = __fmul_rn(fy, tab.lv[lvl].inv);
    }
    const LkLevel& L = tab.lv[lvl];
    float e;
    const bool ok = track_level<kPlanes>(
        back ? L.next : L.prev, back ? L.prev : L.next, L.h, L.w,
        __fmul_rn(qx, L.inv), __fmul_rn(qy, L.inv), gx, gy, win, iters,
        min_eig, sm, lane, wt_walk, win_walk, e);
    ok_all = ok_all && ok;
    if (!back) err = e;
    if (lvl > 0) {
      gx = __fmul_rn(gx, tab.scale);
      gy = __fmul_rn(gy, tab.scale);
    }
  }
  const float dx = __fsub_rn(gx, px);
  const float dy = __fsub_rn(gy, py);
  const float fb_err =
      __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));

  if (lane == 0) {
    out_pts[2 * i] = fx;
    out_pts[2 * i + 1] = fy;
    out_status[i] = (ok_all && fb_err < tab.fb_thresh) ? 1 : 0;
    out_err[i] = err;
  }
}

// Block shape and shared memory for window `win`: gradient planes where one
// warp's fit in a block, up to kWarpsMax warps inside the default 48 KB,
// else one warp with the opt-in limit. Returns false if even the template
// alone does not fit.
struct LaunchShape {
  bool planes;
  int warps;
  int smem;
};

bool launch_shape(int win, LaunchShape& s) {
  const int f = static_cast<int>(sizeof(float));
  s.planes = warp_floats(win, true) * f <= kSmemMax;
  const int per_warp = warp_floats(win, s.planes) * f;
  s.warps = kWarpsMax;
  while (s.warps > 1 && per_warp * s.warps > 48 * 1024) --s.warps;
  s.smem = per_warp * s.warps;
  return s.smem <= kSmemMax;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Launches `reps` times back to back on `stream` (1 on every path; more only
// to time the kernel); returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a window whose template does not fit in shared
// memory or a non-positive window.
extern "C" int gfs_lk_level(const float* prev, const float* next, int h,
                            int w, const float* pts, const float* guess, int n,
                            int win, int iters, float min_eig, float* out_pts,
                            uint8_t* out_ok, float* out_err, int reps,
                            cudaStream_t stream) {
  if (win < 1 || iters < 0 || h < 1 || w < 1) return cudaErrorInvalidValue;
  if (n <= 0) return 0;
  LaunchShape s;
  if (!launch_shape(win, s)) return cudaErrorInvalidValue;
  auto kernel = s.planes ? lk_level_kernel<true> : lk_level_kernel<false>;
  const cudaError_t e = allow_smem(kernel, s.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(32 * s.warps);
  const dim3 grid((n + s.warps - 1) / s.warps);
  for (int rep = 0; rep < reps; ++rep)
    kernel<<<grid, block, s.smem, stream>>>(prev, next, h, w, pts, guess, n,
                                            win, iters, min_eig, out_pts,
                                            out_ok, out_err);
  return static_cast<int>(cudaGetLastError());
}

// The fused launch. prev, next, hs, ws, invs: host arrays over the
// n_levels pyramid levels (device pointers of the level images, their
// shapes, float32(1 / scale^level)); stream_levels: host array of the
// forward level count of each of the n_streams streams (1 .. n_levels).
extern "C" int gfs_lk_pyramid(const float* const* prev,
                              const float* const* next, const int* hs,
                              const int* ws, const float* invs, int n_levels,
                              const int* stream_levels, int n_streams,
                              const float* pts, const float* guess, int n,
                              int fb_levels, float scale, float fb_thresh,
                              int win, int iters, float min_eig,
                              float* out_pts, uint8_t* out_status,
                              float* out_err, int reps, cudaStream_t stream) {
  if (win < 1 || iters < 0 || n_levels < 1 || n_levels > kMaxLevels ||
      n_streams < 1 || n_streams > kMaxStreams || fb_levels < 1)
    return cudaErrorInvalidValue;
  LkTable tab = {};
  for (int l = 0; l < n_levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return cudaErrorInvalidValue;
    tab.lv[l] = {prev[l], next[l], hs[l], ws[l], invs[l]};
  }
  for (int s = 0; s < n_streams; ++s) {
    if (stream_levels[s] < 1 || stream_levels[s] > n_levels)
      return cudaErrorInvalidValue;
    tab.levels[s] = stream_levels[s];
  }
  tab.n_streams = n_streams;
  tab.fb_levels = fb_levels;
  tab.scale = scale;
  tab.fb_thresh = fb_thresh;
  if (n <= 0) return 0;
  LaunchShape s;
  if (!launch_shape(win, s)) return cudaErrorInvalidValue;
  auto kernel = s.planes ? lk_pyramid_kernel<true> : lk_pyramid_kernel<false>;
  const cudaError_t e = allow_smem(kernel, s.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = n_streams * n;
  const dim3 block(32 * s.warps);
  const dim3 grid((total + s.warps - 1) / s.warps);
  for (int rep = 0; rep < reps; ++rep)
    kernel<<<grid, block, s.smem, stream>>>(tab, pts, guess, n, win, iters,
                                            min_eig, out_pts, out_status,
                                            out_err);
  return static_cast<int>(cudaGetLastError());
}
