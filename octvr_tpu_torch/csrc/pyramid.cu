// Pyramid steps of the multiband blend, for Hopper (sm_90a): a 5-tap
// stencil down (pyr_down_kernel) and up (pyr_up_kernel), the up step
// carrying the blend's elementwise work around it as its epilogue.
//
// Replaces no Pallas kernel.  The JAX package runs these steps as two
// banded products per step (octvr_tpu/ops/pyramid.py pyr_down_mm and
// pyr_up_mm, left to XLA: the TPU's matrix unit eats the band's zeros).
// On this card the same products are dense f32 FFMA GEMMs: a 4K set's
// 143 of them do ~333 GFLOP for ~1.05 GFLOP of filter and took two
// thirds of the set's device time, at the card's f32 rate.  The port's
// banded products stay as the plain version (ops/pyramid.py, the CPU
// path of ops/cuda_pyramid.py).
//
// Contract: exactly what down_matrix(n) and up_matrix(n) encode, per
// axis (not the conv form pyr_down/pyr_up, which differs at borders and
// odd sizes):
//   - down, n -> n/2 (n >= 2): output i sums w = [1,4,6,4,1]/16 at
//     sources j = 2i + k - 2, k = 0..4, with j < 0 -> -j and then
//     j >= n -> 2(n-1) - j (reflect-101); taps that land on one source
//     add their weights first, as the matrix row does;
//   - up, n -> 2n (n >= 1): zero-stuffed, w = [1,4,6,4,1]*2/16: an even
//     output o = 2m takes sources m-1, m, m+1 at 2/16, 12/16, 2/16, an
//     odd one o = 2m+1 takes m, m+1 at 8/16, 8/16; a source outside
//     [0, n) is dropped.
// The weights are exact in bf16 and f32.  The vertical pass runs first
// (the product kv @ x), then the horizontal one (@ kh^T); each output of
// a pass is a chain of fmaf over its taps in ascending source order,
// which is the order in which a GEMM's k loop adds the row's nonzero
// terms.  The intermediate stays in f32 in shared memory; the store
// rounds once to the storage type T (the cast after each step, F3).
//
// The up step's epilogue (mode), with rnd the rounding to T after each
// op that torch's eager bf16 ops do (nothing in f32), u the f32 sum:
//   kPlain      out = rnd(u)
//   kLaplacian  out = rnd(out + rnd(rnd(a - rnd(u)) * b)), in place:
//               a the finer Gaussian level, b its weight level, out the
//               band level's window (blenders.multiband_blend's
//               `dst += (g - up(x)) * w`);
//   kCollapse   out = rnd(rnd(u) + rnd(a * b)): a the band level, b its
//               inverse band weight (`up(acc) + dst * inv`).
// Each op is an _rn intrinsic, so nvcc has no contraction to choose.
//
// What bounds it: memory.  The filter is about one flop per byte read
// against the card's ~295 flop/byte ridge.  So the design moves each
// byte once and launches once per step where the eager path launched
// about six times (two matrix casts, an activation cast, two GEMMs, a
// cast back) plus the epilogue's three elementwise kernels:
//   - a block takes a 2-D output tile of one plane (blockIdx.z); down
//     16 x 64 outputs from a staged window of at most 35 x 131 inputs,
//     up 16 x 128 outputs from at most 10 x 66;
//   - it stages the window, halo included, into shared memory once as
//     f32, a warp a row, neighbouring lanes on neighbouring columns
//     (coalesced whatever the row's alignment: the level widths and the
//     band windows' offsets are not multiples of 8);
//   - every global load of a block, the window and the epilogue's
//     operands, is issued before the first is used and behind no
//     branch (a clamped index where the tile ends), so a block waits
//     for memory once.  Measured on an H100 at the 4K plan's largest
//     levels: loads issued a row at a time and used at once ran the
//     down step at ~8% of its byte bound, issued together but each
//     behind a bounds branch at 12-15%, branch-free at 27-33% (the
//     Laplacian step 46%; a set's steps at 22%, PERF.md §6).  Launched
//     per camera and level, a 4K set made 143 launches, 91 of them on
//     levels of 448 rows or fewer at 2.5-4 us each; so the blend launches
//     per level over all its cameras (the grouped kernels below);
//   - the taps of its output rows and columns, folded, are worked out
//     once per block into shared memory while its loads are in flight,
//     so the passes read a fixed 5 taps (weight 0 pads the short lists)
//     and never branch on borders;
//   - the vertical pass writes an f32 tile to shared memory, the
//     horizontal pass reads it and runs the epilogue straight to the
//     store.
//
// Layout: every operand is a stack of planes [P, rows, cols] with unit
// column stride, given as (pointer, plane stride, row stride) in
// elements; a plane stride of 0 broadcasts one plane (a weight level
// over the channels).  Row offsets are 64-bit.  A launch the kernels do
// not take (P outside 1..65535, a length below the minimum, a row
// stride below the row) is refused with cudaErrorInvalidValue.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 5;
constexpr int kDownRows = 16, kDownCols = 64;  // output tile of a down block
constexpr int kUpRows = 16, kUpCols = 128;     // output tile of an up block

enum Mode { kPlain = 0, kLaplacian = 1, kCollapse = 2 };

template <typename T>
struct Plane {
  T* p;
  long long plane;  // elements between planes (0: one plane for all)
  int pitch;        // elements between rows
  __device__ __forceinline__ T* at(int z, int r, int c) const {
    return p + z * plane + (long long)r * pitch + c;
  }
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float rnd(float v, float*) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Output i's taps along an axis of n sources, as row i of
// down_matrix(n) or up_matrix(n).  Tap d (0..4) is source j0 + d, j0 the
// lowest source the output reads, with the weights of the filter taps
// that land on it summed in filter order (0 where none does; such a tap
// reads source j0, times 0).  So the nonzero taps come in ascending
// source order.  Sources are given relative to lo, the staged window's
// first.  All in registers: the loops unroll.
template <bool kUp>
__device__ __forceinline__ void axis_taps(int i, int n, int lo, int* src, float* w) {
  const float kW[kTaps] = {1.0f / 16, 4.0f / 16, 6.0f / 16, 4.0f / 16, 1.0f / 16};
  int j[kTaps];
  bool on[kTaps];
  int j0 = 0x7fffffff;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    if (kUp) {
      const int z = i + k - 2;  // the zero-stuffed axis
      on[k] = z >= 0 && z < 2 * n && !(z & 1);
      j[k] = z >> 1;
    } else {
      int jj = 2 * i + k - 2;
      if (jj < 0) jj = -jj;
      if (jj >= n) jj = 2 * (n - 1) - jj;
      on[k] = true;
      j[k] = jj;
    }
    if (on[k]) j0 = min(j0, j[k]);
  }
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      if (on[k] && j[k] == j0 + d) sum += kUp ? 2.0f * kW[k] : kW[k];
    }
    src[d] = (sum != 0.0f ? j0 + d : j0) - lo;
    w[d] = sum;
  }
}

// The sources [lo, hi] that outputs [o0, o1] of an axis of n read.
template <bool kUp>
__device__ __forceinline__ int2 window(int o0, int o1, int n) {
  if (kUp) return make_int2(max(0, o0 / 2 - 1), min(n - 1, o1 / 2 + 1));
  return make_int2(max(0, 2 * o0 - 2), min(n - 1, 2 * o1 + 2));
}

// One block: the R x C output tile at (oy0, ox0) of plane z; x is
// [P, n_h, n_w].
template <typename T, bool kUp, int R, int C, int kMode>
__device__ __forceinline__ void pyr_tile(Plane<const T> x, int n_h, int n_w,
                                         Plane<const T> a, Plane<const T> b,
                                         Plane<T> out, int oy0, int ox0, int z) {
  constexpr int IR = kUp ? R / 2 + 2 : 2 * R + 3;  // staged rows at most
  constexpr int IC = kUp ? C / 2 + 2 : 2 * C + 3;  // staged columns at most
  constexpr int SR = (IR + kWarps - 1) / kWarps, SC = (IC + 31) / 32;  // window loads of a thread
  constexpr int RW = R / kWarps, CW = C / 32;  // outputs of a thread: rows x columns
  static_assert(R % kWarps == 0 && C % 32 == 0, "a tile is whole warps by whole rows");
  __shared__ float s_in[IR][IC];
  __shared__ float s_v[R][IC];
  __shared__ int s_rsrc[R][kTaps], s_csrc[C][kTaps];
  __shared__ float s_rw[R][kTaps], s_cw[C][kTaps];

  const int oh = kUp ? 2 * n_h : n_h / 2;
  const int ow = kUp ? 2 * n_w : n_w / 2;
  const int rows = min(R, oh - oy0), cols = min(C, ow - ox0);
  const int2 wr = window<kUp>(oy0, oy0 + rows - 1, n_h);
  const int2 wc = window<kUp>(ox0, ox0 + cols - 1, n_w);
  const int rows_in = wr.y - wr.x + 1, cols_in = wc.y - wc.x + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Every global load of the block is issued before the first is used,
  // none behind a branch (an index past the tile is clamped, its value
  // unused): the window into registers, and the epilogue's operands of
  // this thread's outputs (output (r, c) = (warp + i * kWarps, lane +
  // 32 * j)).
  float win[SR][SC];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int r = min(warp + i * kWarps, rows_in - 1), c = min(lane + 32 * j, cols_in - 1);
      win[i][j] = load(x.at(z, wr.x + r, wc.x + c));
    }
  }
  float ea[RW][CW], eb[RW][CW], eo[RW][CW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int r = oy0 + min(warp + i * kWarps, rows - 1), c = ox0 + min(lane + 32 * j, cols - 1);
      if (kMode != kPlain) ea[i][j] = load(a.at(z, r, c)), eb[i][j] = load(b.at(z, r, c));
      if (kMode == kLaplacian) eo[i][j] = load(out.at(z, r, c));
    }
  }
  // while they are in flight: the taps of the tile's rows and columns
  if (tid < rows) {
    axis_taps<kUp>(oy0 + tid, n_h, wr.x, s_rsrc[tid], s_rw[tid]);
  } else if (tid >= R && tid - R < cols) {
    axis_taps<kUp>(ox0 + tid - R, n_w, wc.x, s_csrc[tid - R], s_cw[tid - R]);
  }
#pragma unroll
  for (int i = 0; i < SR; ++i) {
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int r = warp + i * kWarps, c = lane + 32 * j;
      if (r < rows_in && c < cols_in) s_in[r][c] = win[i][j];
    }
  }
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    int sr[kTaps];
    float w[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) sr[k] = s_rsrc[r][k], w[k] = s_rw[r][k];
    for (int c = lane; c < cols_in; c += 32) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = __fmaf_rn(w[k], s_in[sr[k]][c], acc);
      s_v[r][c] = acc;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int r = warp + i * kWarps, c = lane + 32 * j;
      if (r >= rows || c >= cols) continue;
      float u = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) u = __fmaf_rn(s_cw[c][k], s_v[r][s_csrc[c][k]], u);
      T* o = out.at(z, oy0 + r, ox0 + c);
      if (kMode == kLaplacian) {
        const float lap = rnd(__fsub_rn(ea[i][j], rnd(u, o)), o);
        u = __fadd_rn(eo[i][j], rnd(__fmul_rn(lap, eb[i][j]), o));
      } else if (kMode == kCollapse) {
        u = __fadd_rn(rnd(u, o), rnd(__fmul_rn(ea[i][j], eb[i][j]), o));
      }
      store(o, u);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pyr_down_kernel(Plane<const T> x, int n_h, int n_w, Plane<T> out) {
  pyr_tile<T, false, kDownRows, kDownCols, kPlain>(x, n_h, n_w, x, x, out, blockIdx.y * kDownRows,
                                                   blockIdx.x * kDownCols, blockIdx.z);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    pyr_up_kernel(Plane<const T> x, int n_h, int n_w, Plane<const T> a,
                  Plane<const T> b, Plane<T> out) {
  pyr_tile<T, true, kUpRows, kUpCols, kMode>(x, n_h, n_w, a, b, out, blockIdx.y * kUpRows,
                                             blockIdx.x * kUpCols, blockIdx.z);
}

// ---------------------------------------------------------------------
// Grouped launches: every camera of a blend at once.  A blend's Gaussian
// levels live in one arena per level, [P, S_i]: camera k's level i is
// the [h, w] image at element off of each plane (pitch w).  A launch's
// tables (cameras, levels, tile prefix sums) are fixed per plan and
// passed by value, so a graph capture keeps them and nothing is copied
// to the card per call.

constexpr int kMaxCams = 32;   // cameras of one grouped launch
constexpr int kMaxLevels = 8;  // band levels of one gather launch

struct DownCam {
  int src_off, dst_off;   // the camera's levels i and i + 1 in the arenas' planes
  int h, w;               // its level i
  int tiles_x, tile_end;  // its output tiles across; the tiles of cameras 0..k
};

template <typename T>
struct DownGroup {
  const T* src;
  T* dst;
  long long src_plane, dst_plane;  // S_i, S_{i+1}
  int planes, cams;
  DownCam cam[kMaxCams];
};

// Level i -> i + 1 of every camera of a group: the grid is the cameras'
// output tiles one after another, P blocks a tile (the plane varies
// fastest); a block finds its camera from the tile prefix sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pyr_down_group_kernel(const __grid_constant__ DownGroup<T> g) {
  const int z = blockIdx.x % g.planes, t = blockIdx.x / g.planes;
  int k = 0;
  while (k + 1 < g.cams && t >= g.cam[k].tile_end) ++k;
  const DownCam& c = g.cam[k];
  const int tc = t - (k ? g.cam[k - 1].tile_end : 0);
  const Plane<const T> x{g.src + c.src_off, g.src_plane, c.w};
  const Plane<T> out{g.dst + c.dst_off, g.dst_plane, c.w / 2};
  pyr_tile<T, false, kDownRows, kDownCols, kPlain>(x, c.h, c.w, x, x, out, tc / c.tiles_x * kDownRows,
                                                   tc % c.tiles_x * kDownCols, z);
}

template <typename T>
struct LapLevel {
  const T* fine;    // Gaussian arena of level i
  const T* coarse;  // of level i + 1 (unused at the top level)
  T* band;          // band level i, [P, band_h, band_w]
  long long fine_plane, coarse_plane;
  int band_h, band_w, tiles_x, tile_end, top;
};

template <typename T>
struct LapCam {
  const T* wt;               // the camera's weight level i, [h, w]
  int y, x, h, w;            // its aligned ROI on band level i
  int off_fine, off_coarse;  // its levels i and i + 1 in the arenas' planes
};

template <typename T>
struct LapGather {
  int planes, levels, cams, accumulate;
  LapLevel<T> lv[kMaxLevels];
  LapCam<T> cam[kMaxLevels][kMaxCams];
};

// A camera's part of a band tile: tile rows [r0, r1) x columns [c0, c1),
// the tile's row r being the camera's row r + dy (column c + dx), and
// the coarse window [wr.x, wr.y] x [wc.x, wc.y] that the up step there
// reads.
struct Part {
  int dy, dx, r0, r1, c0, c1;
  int2 wr, wc;
};

template <typename T>
__device__ __forceinline__ Part part_of(const LapCam<T>& c, int ty0, int tx0, int rows, int cols) {
  Part p;
  p.dy = ty0 - c.y, p.dx = tx0 - c.x;
  p.r0 = max(0, -p.dy), p.r1 = min(rows, c.h - p.dy);
  p.c0 = max(0, -p.dx), p.c1 = min(cols, c.w - p.dx);
  p.wr = window<true>(p.r0 + p.dy, p.r1 - 1 + p.dy, c.h / 2);
  p.wc = window<true>(p.c0 + p.dx, p.c1 - 1 + p.dx, c.w / 2);
  return p;
}

// The first camera after k whose aligned ROI on level l meets the tile,
// or cams.
template <typename T>
__device__ __forceinline__ int next_cam(const LapGather<T>& g, int l, int k, int ty0, int tx0, int rows,
                                        int cols) {
  for (++k; k < g.cams; ++k) {
    const LapCam<T>& c = g.cam[l][k];
    if (c.y < ty0 + rows && ty0 < c.y + c.h && c.x < tx0 + cols && tx0 < c.x + c.w) break;
  }
  return k;
}

// Every band level of a blend's Laplacian pyramid, summed over the
// cameras, in one launch.  A block owns one kUpRows x kUpCols tile of
// one band level and plane; the grid is every level's tiles one after
// another, the coarse levels first (their tiles meet more cameras), P
// blocks a tile.  The block walks the cameras in ascending index; for
// each whose aligned ROI meets the tile it stages the camera's window of
// Gaussian level i + 1, runs the up step as pyr_tile does, and adds the
// camera's term in registers, rounded as the per-camera steps stored it:
//   level i < B: out = rnd(out + rnd(rnd(a - rnd(u)) * b)), a the
//                camera's Gaussian level i, b its weight level;
//   level B:     out = rnd(out + rnd(a * b)), a its Gaussian level B.
// out starts at 0 (at the stored band in a launch that continues a rig
// split by camera) and is stored once.  What bounds it is latency: a
// camera's part of a tile is one chain of load, sync, compute, so the
// kernel keeps four blocks on an SM (64 registers; measured on an H100
// at the 4K and ring plans' shapes, two blocks of 124 registers ran the
// gather 20-28% slower, and starting the next camera's loads before the
// current camera's passes, which took the registers, gained nothing).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    pyr_lap_gather_kernel(const __grid_constant__ LapGather<T> g) {
  constexpr int R = kUpRows, C = kUpCols;
  constexpr int IR = R / 2 + 2, IC = C / 2 + 2;  // staged window at most: a part starts on an even row and column
  constexpr int SR = (IR + kWarps - 1) / kWarps, SC = (IC + 31) / 32;  // window loads of a thread
  constexpr int RW = R / kWarps, CW = C / 32;                         // outputs of a thread
  __shared__ float s_in[IR][IC];
  __shared__ float s_v[R][IC];
  __shared__ int s_rsrc[R][kTaps], s_csrc[C][kTaps];
  __shared__ float s_rw[R][kTaps], s_cw[C][kTaps];

  const int z = blockIdx.x % g.planes, t = blockIdx.x / g.planes;
  int l = 0;
  while (l + 1 < g.levels && t >= g.lv[l].tile_end) ++l;
  const LapLevel<T>& L = g.lv[l];
  const int tl = t - (l ? g.lv[l - 1].tile_end : 0);
  const int ty0 = tl / L.tiles_x * R, tx0 = tl % L.tiles_x * C;
  const int rows = min(R, L.band_h - ty0), cols = min(C, L.band_w - tx0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool top = L.top;
  const T* fine = L.fine + z * L.fine_plane;
  const T* coarse = L.coarse + z * L.coarse_plane;
  T* band = L.band + (long long)z * L.band_h * L.band_w;

  // this thread's outputs: tile (warp + i * kWarps, lane + 32 * j)
  float acc[RW][CW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int r = min(warp + i * kWarps, rows - 1), c = min(lane + 32 * j, cols - 1);
      acc[i][j] = g.accumulate ? load(band + (long long)(ty0 + r) * L.band_w + tx0 + c) : 0.0f;
    }
  }

  for (int k = next_cam(g, l, -1, ty0, tx0, rows, cols); k < g.cams; k = next_cam(g, l, k, ty0, tx0, rows, cols)) {
    const LapCam<T>& c = g.cam[l][k];
    const Part p = part_of(c, ty0, tx0, rows, cols);
    const int rows_in = p.wr.y - p.wr.x + 1, cols_in = p.wc.y - p.wc.x + 1;
    // the camera's loads, all started before the first is used and none
    // behind a branch (an index past the part is clamped, its value
    // unused): its level i and weights at this thread's outputs, its
    // window of level i + 1
    float ea[RW][CW], eb[RW][CW], win[SR][SC];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int r = min(max(warp + i * kWarps, p.r0), p.r1 - 1) + p.dy;
        const int cc = min(max(lane + 32 * j, p.c0), p.c1 - 1) + p.dx;
        ea[i][j] = load(fine + c.off_fine + (long long)r * c.w + cc);
        eb[i][j] = load(c.wt + (long long)r * c.w + cc);
      }
    }
    if (!top) {
#pragma unroll
      for (int i = 0; i < SR; ++i) {
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int r = p.wr.x + min(warp + i * kWarps, rows_in - 1);
          const int cc = p.wc.x + min(lane + 32 * j, cols_in - 1);
          win[i][j] = load(coarse + c.off_coarse + (long long)r * (c.w / 2) + cc);
        }
      }
      __syncthreads();  // the previous camera's passes are done with shared memory
      // while the loads are in flight: the taps of the part's rows and columns
      if (tid < R) {
        if (tid >= p.r0 && tid < p.r1) axis_taps<true>(tid + p.dy, c.h / 2, p.wr.x, s_rsrc[tid], s_rw[tid]);
      } else if (tid - R < C) {
        const int cc = tid - R;
        if (cc >= p.c0 && cc < p.c1) axis_taps<true>(cc + p.dx, c.w / 2, p.wc.x, s_csrc[cc], s_cw[cc]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int r = warp + i * kWarps, cc = lane + 32 * j;
          if (r < rows_in && cc < cols_in) s_in[r][cc] = win[i][j];
        }
      }
      __syncthreads();
      for (int r = p.r0 + warp; r < p.r1; r += kWarps) {
        int sr[kTaps];
        float w[kTaps];
#pragma unroll
        for (int q = 0; q < kTaps; ++q) sr[q] = s_rsrc[r][q], w[q] = s_rw[r][q];
        for (int cc = lane; cc < cols_in; cc += 32) {
          float v = 0.0f;
#pragma unroll
          for (int q = 0; q < kTaps; ++q) v = __fmaf_rn(w[q], s_in[sr[q]][cc], v);
          s_v[r][cc] = v;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const int r = warp + i * kWarps, cc = lane + 32 * j;
        if (r < p.r0 || r >= p.r1 || cc < p.c0 || cc >= p.c1) continue;
        float term;
        if (top) {
          term = rnd(__fmul_rn(ea[i][j], eb[i][j]), band);
        } else {
          float u = 0.0f;
#pragma unroll
          for (int q = 0; q < kTaps; ++q) u = __fmaf_rn(s_cw[cc][q], s_v[r][s_csrc[cc][q]], u);
          const float lap = rnd(__fsub_rn(ea[i][j], rnd(u, band)), band);
          term = rnd(__fmul_rn(lap, eb[i][j]), band);
        }
        acc[i][j] = rnd(__fadd_rn(acc[i][j], term), band);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int r = warp + i * kWarps, c = lane + 32 * j;
      if (r < rows && c < cols) store(band + (long long)(ty0 + r) * L.band_w + tx0 + c, acc[i][j]);
    }
  }
}

bool bad_planes(int planes, int oh, int rows, int x_pitch, int n_w,
                int out_pitch, int ow) {
  return planes < 1 || planes > 65535 || x_pitch < n_w || out_pitch < ow ||
         (oh + rows - 1) / rows > 65535;
}

template <typename T>
int launch_down(const void* x, long long x_plane, int x_pitch, int n_h,
                int n_w, void* out, long long out_plane, int out_pitch,
                int planes, void* stream) {
  const int oh = n_h / 2, ow = n_w / 2;
  if (n_h < 2 || n_w < 2 ||
      bad_planes(planes, oh, kDownRows, x_pitch, n_w, out_pitch, ow))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + kDownCols - 1) / kDownCols,
                  (oh + kDownRows - 1) / kDownRows, planes);
  pyr_down_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Plane<const T>{(const T*)x, x_plane, x_pitch}, n_h, n_w,
      Plane<T>{(T*)out, out_plane, out_pitch});
  return (int)cudaGetLastError();
}

template <typename T>
int launch_up(int mode, const void* x, long long x_plane, int x_pitch,
              int n_h, int n_w, const void* a, long long a_plane, int a_pitch,
              const void* b, long long b_plane, int b_pitch, void* out,
              long long out_plane, int out_pitch, int planes, void* stream) {
  if (n_h < 1 || n_w < 1 || n_h > (1 << 30) || n_w > (1 << 30))
    return (int)cudaErrorInvalidValue;
  const int oh = 2 * n_h, ow = 2 * n_w;
  if (bad_planes(planes, oh, kUpRows, x_pitch, n_w, out_pitch, ow) ||
      (mode != kPlain && (a_pitch < ow || b_pitch < ow)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((ow + kUpCols - 1) / kUpCols, (oh + kUpRows - 1) / kUpRows,
                  planes);
  const Plane<const T> xs{(const T*)x, x_plane, x_pitch};
  const Plane<const T> as{(const T*)a, a_plane, a_pitch};
  const Plane<const T> bs{(const T*)b, b_plane, b_pitch};
  const Plane<T> os{(T*)out, out_plane, out_pitch};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kPlain:
      pyr_up_kernel<T, kPlain><<<grid, kThreads, 0, s>>>(xs, n_h, n_w, as, bs, os);
      break;
    case kLaplacian:
      pyr_up_kernel<T, kLaplacian><<<grid, kThreads, 0, s>>>(xs, n_h, n_w, as, bs, os);
      break;
    case kCollapse:
      pyr_up_kernel<T, kCollapse><<<grid, kThreads, 0, s>>>(xs, n_h, n_w, as, bs, os);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// A grouped launch's table as the host lays it out (ops/cuda_pyramid.py
// PyramidGroups), 64-bit integers:
//   down:   cams, src_plane, dst_plane, then per camera src_off, dst_off,
//           h, w, tiles_x, tile_end;
//   gather: levels, cams, accumulate, then per level (grid order) the
//           level index i, top, band_h, band_w, fine_plane, coarse_plane,
//           tiles_x, tile_end, then per level and camera y, x, h, w,
//           off_fine, off_coarse, the weight level's pointer.
constexpr int kDownHead = 3, kDownFields = 6;
constexpr int kLapHead = 3, kLevelFields = 8, kCamFields = 7;

bool bad_grid(long long tiles, int planes) {
  return planes < 1 || tiles < 1 || tiles * planes > 0x7fffffffLL;
}

template <typename T>
int launch_down_group(const long long* d, const void* src, void* dst, int planes, void* stream) {
  DownGroup<T> g{};
  const long long cams = d[0];
  if (cams < 1 || cams > kMaxCams) return (int)cudaErrorInvalidValue;
  g.src = (const T*)src, g.dst = (T*)dst;
  g.src_plane = d[1], g.dst_plane = d[2];
  g.planes = planes, g.cams = (int)cams;
  long long last = 0;
  for (int k = 0; k < cams; ++k) {
    const long long* e = d + kDownHead + kDownFields * k;
    if (e[2] < 2 || e[3] < 2 || e[4] < 1 || e[5] <= last) return (int)cudaErrorInvalidValue;
    g.cam[k] = DownCam{(int)e[0], (int)e[1], (int)e[2], (int)e[3], (int)e[4], (int)e[5]};
    last = e[5];
  }
  if (bad_grid(last, planes)) return (int)cudaErrorInvalidValue;
  pyr_down_group_kernel<T><<<(unsigned)(last * planes), kThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lap_gather(const long long* d, const long long* gauss, const long long* band, int n_levels,
                      int planes, void* stream) {
  LapGather<T> g{};
  const long long levels = d[0], cams = d[1];
  if (levels < 1 || levels > kMaxLevels || cams < 1 || cams > kMaxCams) return (int)cudaErrorInvalidValue;
  g.planes = planes, g.levels = (int)levels, g.cams = (int)cams, g.accumulate = d[2] != 0;
  long long last = 0;
  for (int j = 0; j < levels; ++j) {
    const long long* e = d + kLapHead + kLevelFields * j;
    const long long i = e[0];
    const bool top = e[1] != 0;
    if (i < 0 || i + (top ? 0 : 1) >= n_levels || e[6] < 1 || e[7] <= last) return (int)cudaErrorInvalidValue;
    g.lv[j] = LapLevel<T>{(const T*)gauss[i], top ? nullptr : (const T*)gauss[i + 1], (T*)band[i], e[4], e[5],
                          (int)e[2], (int)e[3], (int)e[6], (int)e[7], (int)top};
    last = e[7];
    for (int k = 0; k < cams; ++k) {
      const long long* f = d + kLapHead + kLevelFields * levels + kCamFields * (j * cams + k);
      if (f[2] < 1 || f[3] < 1 || (!top && (f[2] % 2 || f[3] % 2))) return (int)cudaErrorInvalidValue;
      g.cam[j][k] = LapCam<T>{(const T*)f[6], (int)f[0], (int)f[1], (int)f[2], (int)f[3], (int)f[4], (int)f[5]};
    }
  }
  if (bad_grid(last, planes)) return (int)cudaErrorInvalidValue;
  pyr_lap_gather_kernel<T><<<(unsigned)(last * planes), kThreads, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (step, storage type).  Every pointer is
// a device pointer, strides are in elements, stream is a cudaStream_t.
// The up entries take the mode (0 plain, 1 Laplacian, 2 collapse) and
// its two operands a and b (unused in mode 0).  Return:
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take (nothing
// launched).
#define OCTVR_PYR_DOWN_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* x, long long x_plane, int x_pitch, int n_h, \
                      int n_w, void* out, long long out_plane, int out_pitch,  \
                      int planes, void* stream) {                              \
    return launch_down<T>(x, x_plane, x_pitch, n_h, n_w, out, out_plane,       \
                          out_pitch, planes, stream);                          \
  }

#define OCTVR_PYR_UP_ENTRY(NAME, T)                                            \
  extern "C" int NAME(int mode, const void* x, long long x_plane, int x_pitch, \
                      int n_h, int n_w, const void* a, long long a_plane,      \
                      int a_pitch, const void* b, long long b_plane,           \
                      int b_pitch, void* out, long long out_plane,             \
                      int out_pitch, int planes, void* stream) {               \
    return launch_up<T>(mode, x, x_plane, x_pitch, n_h, n_w, a, a_plane,       \
                        a_pitch, b, b_plane, b_pitch, out, out_plane,          \
                        out_pitch, planes, stream);                            \
  }

OCTVR_PYR_DOWN_ENTRY(octvr_pyr_down_f32, float)
OCTVR_PYR_DOWN_ENTRY(octvr_pyr_down_bf16, __nv_bfloat16)
OCTVR_PYR_UP_ENTRY(octvr_pyr_up_f32, float)
OCTVR_PYR_UP_ENTRY(octvr_pyr_up_bf16, __nv_bfloat16)

// The grouped entries: ``desc`` a launch's table (above), ``src``/``dst``
// the arenas of levels i and i + 1; ``gauss`` and ``band`` the device
// pointers of every Gaussian arena and band level, n_levels each.
#define OCTVR_PYR_GROUP_ENTRIES(SUFFIX, T)                                                     \
  extern "C" int octvr_pyr_down_group_##SUFFIX(const long long* desc, const void* src,        \
                                               void* dst, int planes, void* stream) {         \
    return launch_down_group<T>(desc, src, dst, planes, stream);                              \
  }                                                                                            \
  extern "C" int octvr_pyr_lap_gather_##SUFFIX(const long long* desc, const long long* gauss, \
                                               const long long* band, int n_levels,           \
                                               int planes, void* stream) {                    \
    return launch_lap_gather<T>(desc, gauss, band, n_levels, planes, stream);                 \
  }

OCTVR_PYR_GROUP_ENTRIES(f32, float)
OCTVR_PYR_GROUP_ENTRIES(bf16, __nv_bfloat16)
