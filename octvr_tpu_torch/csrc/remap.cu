// Bilinear remap of the stitch paths, for Hopper (sm_90a): two kernels.
//
// Replaces, in octvr_tpu/ops/pallas_remap.py:
//   - _kernel_grouped, launched by pallas_remap_apply_batched with
//     nc=1, paired=True (the yuv420 Y remap), nc=2, paired=True (its
//     U|V remap at half resolution) and nc=3 (the rgb remap of an
//     equal-size camera group): NC = 1, 2, 3 of remap_kernel;
//   - _kernel, launched by pallas_remap_apply (the rgb remap of one
//     input, used for mixed camera sizes): remap_kernel at NC=3 on a
//     size group of one input;
//   - the frames_axis variant of pallas_remap_apply_batched (B frames
//     per launch, behind Mapper.stitch_batch): remap_frames_kernel;
//   - its concat-source mode (pallas_remap_apply_batched with a plan
//     from merge_remap_plans over a list of heights, :1249-1269): each
//     input reads a source block of its own height, the per-band camera
//     row slices of the band-sharded stitcher (parallel/sharded.py,
//     src_windows=True).  A (band, input) pair is just another input of
//     either kernel.
//
// Contract (octvr_tpu/ops/remap.py::remap_plan, f64 on the host):
// px = m*W - 0.5, x0 = clip(floor(px), 0, W-1), x1 = min(x0+1, W-1),
// fx = px - floor(px) (before the clip, so the first half-pixel blends
// pixels 0 and 1), the same for y against the input's own source
// height h_i (the top clip is row 0 of its block, the bottom clamp
// y1 = min(y0+1, h_i-1)); an invalid map (< 0) gives exactly 0.
// The host plan carries x0, y0 (-1 where invalid) and fx, fy per output
// pixel.  The source is uint8, already vignetted and quantized.  The
// kernels accumulate in f32 and only the store casts (round to nearest
// even for bf16).  Taps are plain loads, not texture filtering: a
// texture's clamp and 8-bit weights would break the contract.  The
// arithmetic is written with _rn intrinsics (taps_of, blend), so the
// compiler has no contraction to choose: both kernels and every frame
// count give the same bits for the same pixel.
//
// What bounds them: memory.  A valid pixel reads 16 B of plan (x0, y0,
// fx, fy) and stores 4 or 2 B per channel; an invalid one reads 4 B
// (x0) and stores zeros; its 4*NC source bytes are mostly L2 hits,
// since neighbouring pixels sample neighbouring source pixels, but each
// is a byte gather of its own.  The one-pixel-per-thread kernel these
// replace moved 1.5-2.1 TB/s of the card's 3.35 TB/s of device bytes.
// The design:
//   - remap_kernel (one frame) gives each thread kPixels = 2 pixels of
//     one input, a block's width apart, so that each load and store
//     instruction of a warp still covers 32 neighbouring pixels (128 B
//     of each plan array).  A thread starts both x0 loads, then the
//     y0/fx/fy loads of its valid pixels, then all 4*NC*2 gathers, then
//     its stores: twice the bytes in flight per thread.  An invalid
//     pixel still reads only its x0.  No alignment is assumed, so no
//     plan padding is needed and the output layout is unchanged.
//     Measured on an H100 (PERF.md §6), 2 pixels per thread beat 1 by
//     up to 12%; at 4 ptxas takes 64-96 registers and the resident
//     blocks fall, so pixels in flight per SM hardly grow.  The share of
//     the byte bound falls as NC grows (0.57 at NC=1, 0.46 at NC=3),
//     with the byte gathers per plan byte, so the likelier limit is the
//     gathers' L1/L2 traffic (an inference: no hardware counters were
//     read).
//   - remap_frames_kernel (B frames) gives each thread one pixel: it
//     reads the pixel's plan entry once and loops over the B frames,
//     gathering and storing each frame's NC outputs.  The plan is read
//     once per batch (the frames kernel it replaces read it once per
//     frame, B times 239 MB at 4K with B=4, past the 50 MB L2).  B is a
//     runtime argument with no grid limit.  Starting four frames' gathers
//     before their stores made it 1.5x slower on the card, most likely
//     because four frames' gathers in flight at once lose the L1 hits
//     that neighbouring taps share.
//
// Layout: one frame's source is a run of blocks, each uint8
// [NC, h_b, W], planar, flattened and concatenated; src_rows is the sum
// of the block heights, so a frame holds NC * src_rows * W bytes and
// frame b's source starts at b * NC * src_rows * W.  Input i reads the
// block whose first row (counted in rows of one channel) is
// src_table[i] and whose height is src_table[N + i]; inputs may share a
// block.  The equal-size stack [B, N, NC, H, W] is the case
// src_table = (0, H, .., (N-1)H; H, .., H); the rgb source is the JAX
// pack_rgb quantization without its int32 packing, which exists only
// for the TPU's gather.  Input i owns plan entries [off[i], off[i+1]),
// its ROI pixels in row-major order, and in each frame the output block
// out[NC*off[i] : NC*off[i+1]], laid out [NC, rh, rw]; frame b's output
// starts at b * NC * total.  blockIdx.y picks the input.  Offsets
// within one channel of a frame's source (src_rows * W < 2^31) and
// pixel indices within an input (max_count <= 2^31 - 1 - kPixels *
// kThreads, so the last block's indices fit) are 32-bit; frame,
// source-block and output offsets are 64-bit.  A launch past these
// limits is refused (cudaErrorInvalidValue).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 2;  // pixels per thread of remap_kernel

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One output pixel's four taps, as offsets into one channel of its
// input's source block, and their weights: the plan's formulas term for
// term (ops/remap.py::remap_plan).
struct Taps {
  int o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Taps taps_of(int x0, int y0, float fx, float fy,
                                        int W, int h) {
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, h - 1);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  Taps t;
  t.o00 = y0 * W + x0;
  t.o01 = y0 * W + x1;
  t.o10 = y1 * W + x0;
  t.o11 = y1 * W + x1;
  t.w00 = __fmul_rn(gx, gy);
  t.w01 = __fmul_rn(fx, gy);
  t.w10 = __fmul_rn(gx, fy);
  t.w11 = __fmul_rn(fx, fy);
  return t;
}

// The 4*NC source bytes of one output pixel, loaded before any is used.
template <int NC>
struct Texels {
  uint8_t v[NC][4];
};

template <int NC>
__device__ __forceinline__ void load_texels(const uint8_t* __restrict__ s,
                                            int plane, const Taps& t,
                                            Texels<NC>& x) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint8_t* sc = s + (int64_t)c * plane;
    x.v[c][0] = sc[t.o00];
    x.v[c][1] = sc[t.o01];
    x.v[c][2] = sc[t.o10];
    x.v[c][3] = sc[t.o11];
  }
}

// acc[c] = the four taps of channel c summed in f32, in the plan's
// order (s00 w00 + s01 w01 + s10 w10 + s11 w11).
template <int NC>
__device__ __forceinline__ void blend(const Texels<NC>& x, const Taps& t,
                                      float* acc) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float a = __fmul_rn((float)x.v[c][0], t.w00);
    a = __fmaf_rn((float)x.v[c][1], t.w01, a);
    a = __fmaf_rn((float)x.v[c][2], t.w10, a);
    acc[c] = __fmaf_rn((float)x.v[c][3], t.w11, a);
  }
}

// One frame.  Block (x, i) covers pixels [x*P*kThreads, (x+1)*P*kThreads)
// of input i, P = kPixels; thread t takes pixels x*P*kThreads +
// k*kThreads + t.
template <int NC, typename OutT>
__global__ void __launch_bounds__(kThreads) remap_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ x0s,
    const int32_t* __restrict__ y0s, const float* __restrict__ fxs,
    const float* __restrict__ fys, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ src_table, OutT* __restrict__ out, int W) {
  constexpr int P = kPixels;
  const int i = blockIdx.y;
  const int64_t start = offsets[i];
  const int count = (int)(offsets[i + 1] - start);
  const int first = blockIdx.x * (P * kThreads) + threadIdx.x;
  if (first >= count) return;
  const int h = (int)src_table[gridDim.y + i];
  const int plane = h * W;
  const uint8_t* s = src + src_table[i] * NC * W;
  const int32_t* x0p = x0s + start;
  OutT* o = out + NC * start;

  int x0[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = first + k * kThreads;
    x0[k] = p < count ? x0p[p] : -1;
  }
  Taps t[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (x0[k] >= 0) {
      const int64_t q = start + first + k * kThreads;
      t[k] = taps_of(x0[k], y0s[q], fxs[q], fys[q], W, h);
    }
  }
  Texels<NC> x[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (x0[k] >= 0) load_texels<NC>(s, plane, t[k], x[k]);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int p = first + k * kThreads;
    if (p < count) {
      float acc[NC];
      if (x0[k] >= 0) {
        blend<NC>(x[k], t[k], acc);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) store(o + (int64_t)c * count + p, acc[c]);
    }
  }
}

// B frames.  Block (x, i) covers pixels [x*kThreads, (x+1)*kThreads) of
// input i; each thread one pixel, in every frame.
template <int NC, typename OutT>
__global__ void __launch_bounds__(kThreads) remap_frames_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ x0s,
    const int32_t* __restrict__ y0s, const float* __restrict__ fxs,
    const float* __restrict__ fys, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ src_table, OutT* __restrict__ out, int W,
    long long src_rows, long long total, int n_frames) {
  const int i = blockIdx.y;
  const int64_t start = offsets[i];
  const int count = (int)(offsets[i + 1] - start);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= count) return;
  const int64_t q = start + p;
  const int64_t frame_out = (int64_t)NC * total;
  OutT* o = out + NC * start + p;

  const int x0 = x0s[q];
  if (x0 < 0) {
    for (int b = 0; b < n_frames; ++b) {
#pragma unroll
      for (int c = 0; c < NC; ++c) store(o + b * frame_out + (int64_t)c * count, 0.0f);
    }
    return;
  }
  const int h = (int)src_table[gridDim.y + i];
  const int plane = h * W;
  const Taps t = taps_of(x0, y0s[q], fxs[q], fys[q], W, h);
  const int64_t frame_src = (int64_t)NC * src_rows * W;
  const uint8_t* s = src + src_table[i] * NC * W;
#pragma unroll 4
  for (int b = 0; b < n_frames; ++b) {
    Texels<NC> x;
    load_texels<NC>(s + b * frame_src, plane, t, x);
    float acc[NC];
    blend<NC>(x, t, acc);
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + b * frame_out + (int64_t)c * count, acc[c]);
  }
}

// The last block's pixel indices (below max_count + kPixels * kThreads)
// must fit an int, and so must one channel of a frame's source.
bool bad_shape(int n_inputs, long long max_count, long long total,
               long long src_rows, int W) {
  return n_inputs <= 0 || n_inputs > 65535 || max_count <= 0 ||
         max_count > 0x7fffffffLL - kPixels * kThreads ||
         total < max_count || src_rows <= 0 || W <= 0 ||
         src_rows * W > 0x7fffffffLL;
}

template <int NC, typename OutT>
int launch(const void* src, const void* x0, const void* y0, const void* fx,
           const void* fy, const void* offsets, const void* src_table,
           void* out, int n_inputs, long long max_count, long long total,
           long long src_rows, int W, void* stream) {
  if (bad_shape(n_inputs, max_count, total, src_rows, W))
    return (int)cudaErrorInvalidValue;
  const long long span = kPixels * kThreads;
  const dim3 grid((unsigned)((max_count + span - 1) / span), (unsigned)n_inputs);
  remap_kernel<NC, OutT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)x0, (const int32_t*)y0,
      (const float*)fx, (const float*)fy, (const int64_t*)offsets,
      (const int64_t*)src_table, (OutT*)out, W);
  return (int)cudaGetLastError();
}

template <int NC, typename OutT>
int launch_frames(const void* src, const void* x0, const void* y0,
                  const void* fx, const void* fy, const void* offsets,
                  const void* src_table, void* out, int n_frames,
                  int n_inputs, long long max_count, long long total,
                  long long src_rows, int W, void* stream) {
  if (n_frames <= 0 || bad_shape(n_inputs, max_count, total, src_rows, W))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (max_count + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, (unsigned)n_inputs);
  remap_frames_kernel<NC, OutT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)x0, (const int32_t*)y0,
      (const float*)fx, (const float*)fy, (const int64_t*)offsets,
      (const int64_t*)src_table, (OutT*)out, W, src_rows, total, n_frames);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per (kernel, NC, store type).  Every pointer
// is a device pointer; stream is a cudaStream_t.  Return:
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take (nothing
// launched).
#define OCTVR_REMAP_ENTRY(NAME, NC, T)                                        \
  extern "C" int NAME(const void* src, const void* x0, const void* y0,        \
                      const void* fx, const void* fy, const void* offsets,    \
                      const void* src_table, void* out, int n_inputs,         \
                      long long max_count, long long total,                   \
                      long long src_rows, int W, void* stream) {              \
    return launch<NC, T>(src, x0, y0, fx, fy, offsets, src_table, out,        \
                         n_inputs, max_count, total, src_rows, W, stream);    \
  }

#define OCTVR_REMAP_FRAMES_ENTRY(NAME, NC, T)                                 \
  extern "C" int NAME(const void* src, const void* x0, const void* y0,        \
                      const void* fx, const void* fy, const void* offsets,    \
                      const void* src_table, void* out, int n_frames,         \
                      int n_inputs, long long max_count, long long total,     \
                      long long src_rows, int W, void* stream) {              \
    return launch_frames<NC, T>(src, x0, y0, fx, fy, offsets, src_table, out, \
                                n_frames, n_inputs, max_count, total,         \
                                src_rows, W, stream);                         \
  }

OCTVR_REMAP_ENTRY(octvr_remap_nc1_f32, 1, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc1_bf16, 1, __nv_bfloat16)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_f32, 2, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_bf16, 2, __nv_bfloat16)
OCTVR_REMAP_ENTRY(octvr_remap_nc3_f32, 3, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc3_bf16, 3, __nv_bfloat16)

OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc1_f32, 1, float)
OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc1_bf16, 1, __nv_bfloat16)
OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc2_f32, 2, float)
OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc2_bf16, 2, __nv_bfloat16)
OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc3_f32, 3, float)
OCTVR_REMAP_FRAMES_ENTRY(octvr_remap_frames_nc3_bf16, 3, __nv_bfloat16)
