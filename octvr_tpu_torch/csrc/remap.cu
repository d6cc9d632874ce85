// Bilinear remap of the yuv420 stitch path, for Hopper (sm_90a).
//
// Replaces: octvr_tpu/ops/pallas_remap.py::_kernel_grouped, launched by
// pallas_remap_apply_batched with nc=1, paired=True (the Y remap) and
// nc=2, paired=True (the U|V remap at half resolution).
//
// Contract (octvr_tpu/ops/remap.py::remap_plan, f64 on the host):
// px = m*W - 0.5, x0 = clip(floor(px), 0, W-1), x1 = min(x0+1, W-1),
// fx = px - floor(px) (before the clip, so the first half-pixel blends
// pixels 0 and 1), the same for y; an invalid map (< 0) gives exactly 0.
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
// traffic of the plan and the output.  The design keeps every access to
// the plan and the output coalesced (neighbouring threads, neighbouring
// pixels of one input's ROI) and reads no source byte twice per pixel.
// Packing the plan and fusing the vignette and quantize step into the
// gather are left for later.
//
// Layout: a size group of N inputs shares one source size.  src is
// uint8 [N, NC, H, W].  Input i owns plan entries [off[i], off[i+1]),
// its ROI pixels in row-major order, and the output block
// out[NC*off[i] : NC*off[i+1]], laid out [NC, rh, rw].  blockIdx.y picks
// the input, blockIdx.x * blockDim.x + threadIdx.x the pixel.

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
    OutT* __restrict__ out, int H, int W) {
  const int i = blockIdx.y;
  const int64_t start = offsets[i];
  const int64_t count = offsets[i + 1] - start;
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= count) return;
  const int64_t q = start + p;
  OutT* o = out + NC * start + p;

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
  const int y1 = min(y0 + 1, H - 1);
  // the plan's weight formulas, term for term (ops/remap.py::remap_plan)
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w01 = fx * (1.0f - fy);
  const float w10 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const int64_t plane = (int64_t)H * W;
  const uint8_t* s = src + (int64_t)i * NC * plane;
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
           const void* fy, const void* offsets, void* out, int n_inputs,
           long long max_count, int H, int W, void* stream) {
  if (n_inputs <= 0 || n_inputs > 65535 || max_count <= 0 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (max_count + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)n_inputs);
  remap_kernel<NC, OutT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)x0, (const int32_t*)y0,
      (const float*)fx, (const float*)fy, (const int64_t*)offsets,
      (OutT*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, one per instantiation.  Every pointer is a
// device pointer; stream is a cudaStream_t.  Return: cudaGetLastError()
// after the launch (0 = launched).
#define OCTVR_REMAP_ENTRY(NAME, NC, T)                                     \
  extern "C" int NAME(const void* src, const void* x0, const void* y0,     \
                      const void* fx, const void* fy, const void* offsets, \
                      void* out, int n_inputs, long long max_count, int H, \
                      int W, void* stream) {                               \
    return launch<NC, T>(src, x0, y0, fx, fy, offsets, out, n_inputs,      \
                         max_count, H, W, stream);                         \
  }

OCTVR_REMAP_ENTRY(octvr_remap_nc1_f32, 1, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc1_bf16, 1, __nv_bfloat16)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_f32, 2, float)
OCTVR_REMAP_ENTRY(octvr_remap_nc2_bf16, 2, __nv_bfloat16)
