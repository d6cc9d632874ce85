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
//     Laplacian step 46%; a set's steps at 22%, PERF.md §6).  What is
//     left is mostly fixed cost: a launch on a level of 448 rows or
//     fewer takes 2.5-4 us, and 91 of a 4K set's 143 launches are such
//     (a third of their time);
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

// One block: the R x C output tile (blockIdx.y, blockIdx.x) of plane
// blockIdx.z; x is [P, n_h, n_w].
template <typename T, bool kUp, int R, int C, int kMode>
__device__ __forceinline__ void pyr_tile(Plane<const T> x, int n_h, int n_w,
                                         Plane<const T> a, Plane<const T> b,
                                         Plane<T> out) {
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
  const int oy0 = blockIdx.y * R, ox0 = blockIdx.x * C, z = blockIdx.z;
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
  pyr_tile<T, false, kDownRows, kDownCols, kPlain>(x, n_h, n_w, x, x, out);
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    pyr_up_kernel(Plane<const T> x, int n_h, int n_w, Plane<const T> a,
                  Plane<const T> b, Plane<T> out) {
  pyr_tile<T, true, kUpRows, kUpCols, kMode>(x, n_h, n_w, a, b, out);
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
