// Batched ungated best-two Hamming search for Hopper (sm_90a).
//
// Replaces the TPU kernel
// geoflowslam_tpu/ops/pallas_kernels.py::_hamming_kernel (entry
// hamming_argmin2_pallas), which is the unmasked body of
// geoflowslam_tpu/ops/matching.py::match_descriptors. Plain version beside
// it: geoflowslam_tpu_torch/ops/matching.py::hamming_best2_plain, which this
// kernel matches exactly, search by search.
//
// One launch runs S independent searches, described by a table in the
// kernel's parameters (__grid_constant__). For each search and each query
// i over all targets j: the distance is the 256-bit Hamming distance when
// both q_valid[i] and t_valid[j] are set, else `big`. Outputs the best and
// second-best distance and the argbest, ties to the lowest target index
// (XLA top_k's and argmin's order); a row with no valid pair reads
// (big, big, 0), as top_k and argmin over an all-`big` row give index 0.
// The mutual check of match_descriptors is the same search with the sides
// swapped: one more entry of the same table, not a second launch.
//
// What bounds it on the card. A relocalization attempt asks for six 1000 x
// 1000 searches (three candidates, both directions), 6 M pairs. As XOR +
// __popc that is 48 M popcounts, and the popcount pipe does 16 a clock an
// SM on compute capability 9.0 (1/8 of the float32 rate): that body took
// 0.0185 ms for the six on an H100, and an int8 tensor-core product with
// the bits unpacked in registers (mma.m16n8k32 .s8, eight a tile) 0.0178,
// held back by the unpacking (PERF.md records both). The TPU kernel
// computed the distances as a +-1 matmul on the MXU; here they are the
// 1-bit product on the tensor cores, mma.m16n8k256 .b1 .and.popc: one
// instruction a 16 x 8 tile of pairs, the words used as they are,
// d = popc(q) + popc(t) - 2 popc(q & t), exact in integers (0.0084 ms for
// the six). Its least time is that of the product, 6 M x 256 bit
// multiply-adds at the data sheet's int8 rate (no 1-bit rate is published),
// 0.0016 ms, above the epilogue's ~8 integer operations a pair at the
// CUDA cores' rate, 0.0007 ms. The epilogue: each (distance, index) is
// packed into one key, (d << 23) | j, so that the running best and second
// are three unsigned min/max operations a pair, keys are unique (ties fall
// to the lower index in any order of visit), and lanes, warps and tiles
// merge in any order. A pair with an invalid side is the key 0xffffffff.
//
// Layout: a block of 8 warps owns one tile of 16 query rows of one search;
// warp w takes the target tiles of 8 columns w, w + 8, ..., reading them
// from device memory (L2) straight into its mma fragments. A relocalization
// batch is 378 blocks (6 x 63), about three an SM. The warps' results meet
// in shared memory at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSearches = 64;   // entries of the parameter table
constexpr int kWarps = 8;
constexpr int kIdxBits = 23;       // a key's index field: targets < 2^23
constexpr uint32_t kIdxMask = (1u << kIdxBits) - 1u;
constexpr uint32_t kNone = 0xffffffffu;

struct Search {
  const uint32_t* q_desc;   // [n, 8]
  const uint8_t* q_valid;   // [n]
  const uint32_t* t_desc;   // [m, 8]
  const uint8_t* t_valid;   // [m]
  int n, m;
  int out_off;              // its [3, n] block (best, second, idx) in out
  int tile0;                // its first 16-row tile in the grid
};

struct Table {
  Search s[kMaxSearches];
  int n_searches, big;
  int* out;
};

__device__ __forceinline__ void push(uint32_t& best, uint32_t& second,
                                     uint32_t key) {
  second = min(second, max(best, key));
  best = min(best, key);
}

__device__ __forceinline__ void merge(uint32_t& best, uint32_t& second,
                                      uint32_t ob, uint32_t os) {
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

__device__ __forceinline__ uint4 load_desc(const uint32_t* desc, int j,
                                           int half) {
  return __ldg(reinterpret_cast<const uint4*>(desc + 8 * j) + half);
}

__device__ __forceinline__ uint32_t word(const uint4& lo, const uint4& hi,
                                         int w) {
  switch (w) {
    case 0: return lo.x;
    case 1: return lo.y;
    case 2: return lo.z;
    case 3: return lo.w;
    case 4: return hi.x;
    case 5: return hi.y;
    case 6: return hi.z;
    default: return hi.w;
  }
}

__device__ __forceinline__ int popc8(const uint4& lo, const uint4& hi) {
  return __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
         __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
}

__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's share of the A operand (16 x 256, row-major): k 32t.. of its
// rows g and g + 8 is their word t, k 128+32t.. their word 4 + t.
struct QueryFrag {
  uint32_t a0, a1, a2, a3;
};

__device__ __forceinline__ QueryFrag query_frag(const uint4& qa0,
                                                const uint4& qa1,
                                                const uint4& qb0,
                                                const uint4& qb1, int t) {
  return {word(qa0, qa1, t), word(qb0, qb1, t), word(qa0, qa1, 4 + t),
          word(qb0, qb1, 4 + t)};
}

// d <- the distances of (g, jc), (g, jc + 1), (g + 8, jc), (g + 8, jc + 1),
// jc = j0 + 2t, each shifted left by kIdxBits; pa, pb: the popcounts of
// rows g and g + 8, shifted likewise. B holds the same words of target
// j0 + g (zeros past m); an all-ones A row gives the targets' popcounts.
__device__ __forceinline__ void tile_dist(const QueryFrag& q,
                                          const uint32_t* __restrict__ t_desc,
                                          int m, int j0, int g, int t,
                                          uint32_t pa, uint32_t pb,
                                          uint32_t (&d)[4]) {
  const int jg = j0 + g;
  const uint32_t b0 = jg < m ? __ldg(t_desc + 8 * jg + t) : 0u;
  const uint32_t b1 = jg < m ? __ldg(t_desc + 8 * jg + 4 + t) : 0u;
  int c[4] = {0, 0, 0, 0};
  int p[4] = {0, 0, 0, 0};
  mma_b1(c, q.a0, q.a1, q.a2, q.a3, b0, b1);
  mma_b1(p, kNone, kNone, kNone, kNone, b0, b1);
  const uint32_t p0 = static_cast<uint32_t>(p[0]) << kIdxBits;
  const uint32_t p1 = static_cast<uint32_t>(p[1]) << kIdxBits;
  d[0] = pa + p0 - (static_cast<uint32_t>(c[0]) << (kIdxBits + 1));
  d[1] = pa + p1 - (static_cast<uint32_t>(c[1]) << (kIdxBits + 1));
  d[2] = pb + p0 - (static_cast<uint32_t>(c[2]) << (kIdxBits + 1));
  d[3] = pb + p1 - (static_cast<uint32_t>(c[3]) << (kIdxBits + 1));
}

__global__ void __launch_bounds__(kWarps * 32)
hamming_best2_kernel(const __grid_constant__ Table tab) {
  __shared__ uint32_t s_best[kWarps][16];
  __shared__ uint32_t s_second[kWarps][16];

  int si = 0;
  while (si + 1 < tab.n_searches &&
         tab.s[si + 1].tile0 <= static_cast<int>(blockIdx.x))
    ++si;
  const uint32_t* __restrict__ q_desc = tab.s[si].q_desc;
  const uint32_t* __restrict__ t_desc = tab.s[si].t_desc;
  const uint8_t* __restrict__ t_valid = tab.s[si].t_valid;
  const int n = tab.s[si].n;
  const int m = tab.s[si].m;
  const int row0 = (blockIdx.x - tab.s[si].tile0) * 16;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // mma group: query rows g, g + 8; target col g
  const int t = lane & 3;    // thread in group: result columns 2t, 2t + 1
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // this lane's two query rows (zeros past n)
  const int ra = row0 + g, rb = row0 + g + 8;
  const uint4 qa0 = ra < n ? load_desc(q_desc, ra, 0) : zero;
  const uint4 qa1 = ra < n ? load_desc(q_desc, ra, 1) : zero;
  const uint4 qb0 = rb < n ? load_desc(q_desc, rb, 0) : zero;
  const uint4 qb1 = rb < n ? load_desc(q_desc, rb, 1) : zero;
  const uint32_t pa = static_cast<uint32_t>(popc8(qa0, qa1)) << kIdxBits;
  const uint32_t pb = static_cast<uint32_t>(popc8(qb0, qb1)) << kIdxBits;
  const QueryFrag q = query_frag(qa0, qa1, qb0, qb1, t);

  uint32_t best_a = kNone, second_a = kNone;   // row g
  uint32_t best_b = kNone, second_b = kNone;   // row g + 8
  const int n_tiles = (m + 7) >> 3;
#pragma unroll 2
  for (int ct = warp; ct < n_tiles; ct += kWarps) {
    const int j0 = ct * 8;
    const int jc = j0 + 2 * t;   // this lane's result columns jc, jc + 1
    const uint32_t mask0 = (jc < m && t_valid[jc]) ? 0u : kNone;
    const uint32_t mask1 = (jc + 1 < m && t_valid[jc + 1]) ? 0u : kNone;
    uint32_t d[4];
    tile_dist(q, t_desc, m, j0, g, t, pa, pb, d);
    push(best_a, second_a, (d[0] | jc) | mask0);
    push(best_a, second_a, (d[1] | (jc + 1)) | mask1);
    push(best_b, second_b, (d[2] | jc) | mask0);
    push(best_b, second_b, (d[3] | (jc + 1)) | mask1);
  }

  // the four lanes of a group hold the same two rows
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    merge(best_a, second_a, __shfl_xor_sync(0xffffffffu, best_a, off),
          __shfl_xor_sync(0xffffffffu, second_a, off));
    merge(best_b, second_b, __shfl_xor_sync(0xffffffffu, best_b, off),
          __shfl_xor_sync(0xffffffffu, second_b, off));
  }
  if (t == 0) {
    s_best[warp][g] = best_a;
    s_second[warp][g] = second_a;
    s_best[warp][g + 8] = best_b;
    s_second[warp][g + 8] = second_b;
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < 16 && row0 + r < n) {
    uint32_t best = kNone, second = kNone;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) merge(best, second, s_best[w][r],
                                           s_second[w][r]);
    const int row = row0 + r;
    const bool q_ok = tab.s[si].q_valid[row] != 0;
    const uint32_t bd = best >> kIdxBits, sd = second >> kIdxBits;
    const bool has = q_ok && bd <= 256u;
    int* out = tab.out + tab.s[si].out_off + row;
    out[0] = has ? static_cast<int>(bd) : tab.big;
    out[n] = (q_ok && sd <= 256u) ? static_cast<int>(sd) : tab.big;
    out[2 * n] = has ? static_cast<int>(best & kIdxMask) : 0;
  }
}

}  // namespace

// Runs the n_searches searches of the table in one launch, `reps` times
// back to back on `stream` (1 on every path; more only to time the kernel).
// ptrs holds 4 pointers a search (q_desc, q_valid, t_desc, t_valid), dims 2
// ints (n, m); out holds 3 sum(n) int32, search after search, each a [3, n]
// block (best, second, idx). Returns the cudaError_t of the launch (0 =
// success); cudaErrorInvalidValue for a table the kernel does not take.
extern "C" int gfs_hamming_best2(const void* const* ptrs, const int* dims,
                                 int n_searches, int big, int* out, int reps,
                                 cudaStream_t stream) {
  if (n_searches < 1 || n_searches > kMaxSearches)
    return static_cast<int>(cudaErrorInvalidValue);
  Table tab;
  int tiles = 0, rows = 0;
  for (int s = 0; s < n_searches; ++s) {
    Search& e = tab.s[s];
    e.q_desc = static_cast<const uint32_t*>(ptrs[4 * s]);
    e.q_valid = static_cast<const uint8_t*>(ptrs[4 * s + 1]);
    e.t_desc = static_cast<const uint32_t*>(ptrs[4 * s + 2]);
    e.t_valid = static_cast<const uint8_t*>(ptrs[4 * s + 3]);
    e.n = dims[2 * s];
    e.m = dims[2 * s + 1];
    if (e.n < 0 || e.m < 0 || e.m > static_cast<int>(kIdxMask))
      return static_cast<int>(cudaErrorInvalidValue);
    e.out_off = 3 * rows;
    e.tile0 = tiles;
    rows += e.n;
    tiles += (e.n + 15) / 16;
  }
  tab.n_searches = n_searches;
  tab.big = big;
  tab.out = out;
  if (tiles == 0) return 0;
  for (int rep = 0; rep < reps; ++rep)
    hamming_best2_kernel<<<tiles, kWarps * 32, 0, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}
