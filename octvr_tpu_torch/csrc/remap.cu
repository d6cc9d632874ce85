// Bilinear remap of the stitch paths, for Hopper (sm_90a).
//
// Replaces, in octvr_tpu/ops/pallas_remap.py:
//   - _kernel_grouped, launched by pallas_remap_apply_batched with
//     nc=1, paired=True (the yuv420 Y remap), nc=2, paired=True (its
//     U|V remap at half resolution) and nc=3 (the rgb remap of an
//     equal-size camera group): NC = 1, 2, 3 here;
//   - _kernel, launched by pallas_remap_apply (the rgb remap of one
//     input, used for mixed camera sizes): the NC=3 kernel launched on a
//     size group of one input;
//   - the frames_axis variant of pallas_remap_apply_batched (B frames
//     per launch, behind Mapper.stitch_batch): blockIdx.z is the frame;
//   - its concat-source mode (pallas_remap_apply_batched with a plan
//     from merge_remap_plans over a list of heights, :1249-1269): each
//     input reads a source block of its own height, the per-band camera
//     row slices of the band-sharded stitcher (parallel/sharded.py,
//     src_windows=True).  A (band, input) pair is just another input of
//     the launch.
//
// Contract (octvr_tpu/ops/remap.py::remap_plan, f64 on the host):
// px = m*W - 0.5, x0 = clip(floor(px), 0, W-1), x1 = min(x0+1, W-1),
// fx = px - floor(px) (before the clip, so the first half-pixel blends
// pixels 0 and 1), the same for y against the input's own source
// height h_i (the top clip is row 0 of its block, the bottom clamp
// y1 = min(y0+1, h_i-1)); an invalid map (< 0) gives exactly 0.
// The host plan carries x0, y0 (-1 where invalid) and fx, fy per output
// pixel.  The source is uint8, already vignetted and quantized.  The
// kernel accumulates in f32 and only the store casts (round to nearest
// even for bf16).  Taps are plain loads, not texture filtering: a
// texture's clamp and 8-bit weights would break the contract.
//
// Bound: one thread per output pixel.  Each pixel reads 16 B of plan
// (x0, y0, fx, fy) and writes 4 or 2 B per channel; its 4*NC source
// bytes are mostly L2 hits, since neighbouring pixels sample
// neighbouring source pixels.  So the kernel is bound by device-memory
// traffic of the plan and the output, in every mode: the per-input
// source row and height are two loads per thread from one address per
// block (a broadcast).  The design keeps every access to the plan and
// the output coalesced (neighbouring threads, neighbouring pixels of one
// input's ROI) and reads no source byte twice per pixel.  Packing the
// plan and fusing the vignette and quantize step into the gather are
// left for later.
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
// starts at b * NC * total.  blockIdx.z picks the frame, blockIdx.y the
// input, blockIdx.x * blockDim.x + threadIdx.x the pixel.  The plan is
// the same for every frame, so a frames launch reads it once from
// device memory and B times from L2 at best; source and output offsets
// are 64-bit (B x 16.8 M pixels at 4K).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int NC, typename OutT>
__global__ void __launch_bounds__(kThreads) remap_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ x0s,
    const int32_t* __restrict__ y0s, const float* __restrict__ fxs,
    const float* __restrict__ fys, const int64_t* __restrict__ offsets,
    const int64_t* __restrict__ src_table, OutT* __restrict__ out, int W,
    long long src_rows, long long total) {
  const int i = blockIdx.y;
  const int64_t f = blockIdx.z;
  const int64_t start = offsets[i];
  const int64_t count = offsets[i + 1] - start;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= count) return;
  const int64_t q = start + p;
  const int64_t row0 = src_table[i];
  const int h = (int)src_table[gridDim.y + i];
  const int64_t plane = (int64_t)h * W;
  OutT* o = out + f * NC * (int64_t)total + NC * start + p;

  const int x0 = x0s[q];
  if (x0 < 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + c * count, 0.0f);
    return;
  }
  const int y0 = y0s[q];
  const float fx = fxs[q];
  const float fy = fys[q];
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, h - 1);
  // the plan's weight formulas, term for term (ops/remap.py::remap_plan)
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const uint8_t* s = src + (f * src_rows + row0) * NC * W;
  const int64_t r0 = (int64_t)y0 * W;
  const int64_t r1 = (int64_t)y1 * W;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const uint8_t* sc = s + c * plane;
    float acc = 0.0f;
    acc += (float)sc[r0 + x0] * w00;
    acc += (float)sc[r0 + x1] * w01;
    acc += (float)sc[r1 + x0] * w10;
    acc += (float)sc[r1 + x1] * w11;
    store(o + c * count, acc);
  }
}

template <int NC, typename OutT>
int launch(const void* src, const void* x0, const void* y0, const void* fx,
           const void* fy, const void* offsets, const void* src_table,
           void* out, int n_frames, int n_inputs, long long max_count,
           long long total, long long src_rows, int W, void* stream) {
  if (n_frames <= 0 || n_frames > 65535 || n_inputs <= 0 ||
      n_inputs > 65535 || max_count <= 0 || total < max_count ||
      src_rows <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (max_count + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)n_inputs, (unsigned)n_frames);
  remap_kernel<NC, OutT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)x0, (const int32_t*)y0,
      (const float*)fx, (const float*)fy, (const int64_t*)offsets,
      (const int64_t*)src_table, (OutT*)out, W, src_rows, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per instantiation.  Every pointer is a
// device pointer; stream is a cudaStream_t.  Return: cudaGetLastError()
// after the launch (0 = launched).
#define OCTVR_REMAP_ENTRY(NAME, NC, T)                                      \
  extern "C" int NAME(const void* src, const void* x0, const void* y0,      \
                      const void* fx, const void* fy, const void* offsets,  \
                      const void* src_table, void* out, int n_frames,       \
                      int n_inputs, long long max_count, long long total,   \
                      long long src_rows, int W, void* stream) {            \
    return launch<NC, T>(src, x0, y0, fx, fy, offsets, src_table, out,      \
                         n_frames, n_inputs, max_count, total, src_rows, W, \
                         stream);                                           \
  }

OCTVR_REMAP_ENTRY(octvr_remap_nc1_f32, 1, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc1_bf16, 1, __nv_bfloat16)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_f32, 2, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_bf16, 2, __nv_bfloat16)
OCTVR_REMAP_ENTRY(octvr_remap_nc3_f32, 3, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc3_bf16, 3, __nv_bfloat16)
