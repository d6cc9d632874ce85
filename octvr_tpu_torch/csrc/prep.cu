// Input stage of the yuv420 pipeline, for Hopper (sm_90a): one pass
// (prep_yuv_kernel) from a stack of packed YUV420P or NV12 frames to the
// uint8 Y and U|V planes that the remap reads, with the camera's
// vignette applied.
//
// Replaces no Pallas kernel.  The JAX package preps a frame with plain
// XLA ops (octvr_tpu/stitch/mapper.py _prep_pack_yuv), which XLA fuses
// on the TPU.  Eager torch on this card did not: the split, the stack of
// U and V, the casts, the multiply, two clamps, the rounding and the
// cast back were 15 launches a frame, each f32 pass writing and reading
// a full-frame plane again, about 300 MB for a 1920^2 frame.  The plain
// version stays as the CPU path (ops/cuda_prep.py prep_yuv_reference).
//
// Contract, per frame [H*3/2, W] (H, W even) and value, exactly the
// eager ops' f32 arithmetic, each op rounded once:
//   Y   out = q(y * v)                      v the vignette [H, W]
//   U|V out = q((c - 128) * vh + 128)       vh the chroma-grid vignette
//                                           [H/2, W/2], c - 128 exact
//   q(x) = min(max(rint(min(max(x, 0), 255)), 0), 255) as uint8, rint
//   rounding half to even (torch.round).
// Each op is an _rn intrinsic, so nvcc cannot contract the chroma
// expression into one fmaf (which rounds once where torch rounds twice,
// and changes some bytes).  Frame layout (ops/color.py): Y is rows
// [0, H); YUV420P has U at rows [H, H*3/2) columns [0, W/2) and V at
// columns [W/2, W); NV12 interleaves U and V in those rows (UVUV).
//
// What bounds it: memory.  Two multiplies a byte against the card's
// ~295 flop/byte ridge.  A 1920^2 frame must read the packed frame (5.53
// MB), the f32 vignette (14.75 MB) and the chroma vignette (3.69 MB) and
// write Y (3.69 MB) and U|V (1.84 MB): 29.5 MB, 8.8 us at 3.35 TB/s.
// The design meets that bound by moving each byte once:
//   - one thread takes one chroma site span: two luma rows of 8 columns,
//     the 4 U and 4 V values below them and the matching vignette
//     values; neighbouring threads take neighbouring spans of a row, so
//     every load and store of a warp is contiguous;
//   - every load is issued before the first is used: 8-byte luma, 4-byte
//     (YUV420P) or 8-byte (NV12, deinterleaved in registers) chroma,
//     float4 vignettes; no f32 intermediate goes to device memory;
//   - blockIdx.z walks the leading planes of the stack, one launch for
//     all of them.
// The vector path needs every row aligned: W a multiple of 8 and the
// pointers, plane strides and row pitches aligned to the vector widths
// (the launcher checks).  Any other even geometry or view runs the same
// arithmetic with byte and float loads, the last span of a row masked.
//
// Layout: the frame is a stack of planes [P, H*3/2, >=W] given as
// (pointer, plane stride, row pitch) in bytes; each vignette a stack of
// n planes (pointer, plane stride, row pitch in floats, n), plane z of
// the frame taking vignette plane z % n (n = 1 broadcasts, n = k gives
// each of k blocks its own); the outputs are dense, Y [P, H, W] and U|V
// [P, 2, H/2, W/2].  A launch the kernel does not take (P outside
// 1..65535, H or W odd or below 2, a pitch below its row, n < 1) is
// refused with cudaErrorInvalidValue.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 8;  // luma columns a thread takes: 4 chroma sites
constexpr int kSites = kSpan / 2;

enum Format { kYuv420p = 0, kNv12 = 1 };

__device__ __forceinline__ uint32_t q8(float x) {
  x = fminf(fmaxf(x, 0.0f), 255.0f);
  x = rintf(x);
  return (uint32_t)fminf(fmaxf(x, 0.0f), 255.0f);
}

__device__ __forceinline__ uint32_t luma(uint32_t y, float v) {
  return q8(__fmul_rn((float)y, v));
}

__device__ __forceinline__ uint32_t chroma(uint32_t c, float vh) {
  return q8(__fadd_rn(__fmul_rn(__fsub_rn((float)c, 128.0f), vh), 128.0f));
}

__device__ __forceinline__ uint32_t byte(uint32_t word, int i) {
  return (word >> (8 * i)) & 0xffu;
}

template <int kFormat, bool kVec>
__global__ void __launch_bounds__(kThreads)
    prep_yuv_kernel(const uint8_t* __restrict__ src, long long src_plane,
                    long long src_pitch, int h, int w,
                    const float* __restrict__ vig, long long vig_plane,
                    long long vig_pitch, int vig_count,
                    const float* __restrict__ vh, long long vh_plane,
                    long long vh_pitch, int vh_count,
                    uint8_t* __restrict__ out_y, uint8_t* __restrict__ out_uv) {
  const int hc = h >> 1, wc = w >> 1;
  const int spans = (w + kSpan - 1) / kSpan;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= hc * spans) return;
  const int r = idx / spans;               // chroma row: luma rows 2r, 2r+1
  const int c0 = (idx - r * spans) * kSpan;  // first luma column
  const int cc = c0 >> 1;                  // first chroma column
  const long long z = blockIdx.z;

  const uint8_t* fy = src + z * src_plane + 2LL * r * src_pitch + c0;
  const uint8_t* fc = src + z * src_plane + (long long)(h + r) * src_pitch;
  const float* pv = vig + (z % vig_count) * vig_plane + 2LL * r * vig_pitch + c0;
  const float* ph = vh + (z % vh_count) * vh_plane + (long long)r * vh_pitch + cc;
  uint8_t* oy = out_y + z * h * (long long)w + 2LL * r * w + c0;
  uint8_t* ou = out_uv + z * 2 * hc * (long long)wc + (long long)r * wc + cc;
  uint8_t* ov = ou + (long long)hc * wc;

  if (kVec) {
    const uint2 y0 = __ldg(reinterpret_cast<const uint2*>(fy));
    const uint2 y1 = __ldg(reinterpret_cast<const uint2*>(fy + src_pitch));
    uint32_t u, v;
    if (kFormat == kNv12) {
      const uint2 uv = __ldg(reinterpret_cast<const uint2*>(fc + c0));
      u = __byte_perm(uv.x, uv.y, 0x6420);  // bytes 0, 2, 4, 6
      v = __byte_perm(uv.x, uv.y, 0x7531);  // bytes 1, 3, 5, 7
    } else {
      u = __ldg(reinterpret_cast<const uint32_t*>(fc + cc));
      v = __ldg(reinterpret_cast<const uint32_t*>(fc + wc + cc));
    }
    const float4 v00 = __ldg(reinterpret_cast<const float4*>(pv));
    const float4 v01 = __ldg(reinterpret_cast<const float4*>(pv + 4));
    const float4 v10 = __ldg(reinterpret_cast<const float4*>(pv + vig_pitch));
    const float4 v11 = __ldg(reinterpret_cast<const float4*>(pv + vig_pitch + 4));
    const float4 hv = __ldg(reinterpret_cast<const float4*>(ph));

    const float a[kSpan] = {v00.x, v00.y, v00.z, v00.w, v01.x, v01.y, v01.z, v01.w};
    const float b[kSpan] = {v10.x, v10.y, v10.z, v10.w, v11.x, v11.y, v11.z, v11.w};
    const float hs[kSites] = {hv.x, hv.y, hv.z, hv.w};
    uint2 o0 = make_uint2(0, 0), o1 = make_uint2(0, 0);
    uint32_t ou4 = 0, ov4 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o0.x |= luma(byte(y0.x, i), a[i]) << (8 * i);
      o0.y |= luma(byte(y0.y, i), a[4 + i]) << (8 * i);
      o1.x |= luma(byte(y1.x, i), b[i]) << (8 * i);
      o1.y |= luma(byte(y1.y, i), b[4 + i]) << (8 * i);
      ou4 |= chroma(byte(u, i), hs[i]) << (8 * i);
      ov4 |= chroma(byte(v, i), hs[i]) << (8 * i);
    }
    *reinterpret_cast<uint2*>(oy) = o0;
    *reinterpret_cast<uint2*>(oy + w) = o1;
    *reinterpret_cast<uint32_t*>(ou) = ou4;
    *reinterpret_cast<uint32_t*>(ov) = ov4;
  } else {
    // the same arithmetic a value at a time; the last span of a row may
    // hold 2, 4 or 6 columns (W is even)
    const int n = min(kSpan, w - c0);
    uint32_t y0[kSpan], y1[kSpan], u[kSites], v[kSites];
    float a[kSpan], b[kSpan], hs[kSites];
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      const bool on = j < n;
      y0[j] = on ? fy[j] : 0u;
      y1[j] = on ? fy[src_pitch + j] : 0u;
      a[j] = on ? pv[j] : 0.0f;
      b[j] = on ? pv[vig_pitch + j] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kSites; ++t) {
      const bool on = 2 * t < n;
      if (kFormat == kNv12) {
        u[t] = on ? fc[c0 + 2 * t] : 0u;
        v[t] = on ? fc[c0 + 2 * t + 1] : 0u;
      } else {
        u[t] = on ? fc[cc + t] : 0u;
        v[t] = on ? fc[wc + cc + t] : 0u;
      }
      hs[t] = on ? ph[t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (j < n) {
        oy[j] = (uint8_t)luma(y0[j], a[j]);
        oy[w + j] = (uint8_t)luma(y1[j], b[j]);
      }
    }
#pragma unroll
    for (int t = 0; t < kSites; ++t) {
      if (2 * t < n) {
        ou[t] = (uint8_t)chroma(u[t], hs[t]);
        ov[t] = (uint8_t)chroma(v[t], hs[t]);
      }
    }
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int kFormat>
void launch(bool vec, dim3 grid, cudaStream_t s, const uint8_t* src,
            long long src_plane, long long src_pitch, int h, int w,
            const float* vig, long long vig_plane, long long vig_pitch,
            int vig_count, const float* vh, long long vh_plane,
            long long vh_pitch, int vh_count, uint8_t* out_y,
            uint8_t* out_uv) {
  if (vec)
    prep_yuv_kernel<kFormat, true><<<grid, kThreads, 0, s>>>(
        src, src_plane, src_pitch, h, w, vig, vig_plane, vig_pitch, vig_count,
        vh, vh_plane, vh_pitch, vh_count, out_y, out_uv);
  else
    prep_yuv_kernel<kFormat, false><<<grid, kThreads, 0, s>>>(
        src, src_plane, src_pitch, h, w, vig, vig_plane, vig_pitch, vig_count,
        vh, vh_plane, vh_pitch, vh_count, out_y, out_uv);
}

}  // namespace

// Plain C entry point.  format: 0 YUV420P, 1 NV12.  Every pointer is a
// device pointer; the frame's strides are in bytes, the vignettes' in
// floats; stream is a cudaStream_t.  Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a launch the
// kernel does not take (nothing launched).
extern "C" int octvr_prep_yuv(int format, const void* src, long long src_plane,
                              long long src_pitch, int h, int w,
                              const void* vig, long long vig_plane,
                              long long vig_pitch, int vig_count,
                              const void* vh, long long vh_plane,
                              long long vh_pitch, int vh_count, void* out_y,
                              void* out_uv, int planes, void* stream) {
  const long long spans = (w + kSpan - 1) / kSpan;
  const long long threads = (long long)(h / 2) * spans;
  if ((format != kYuv420p && format != kNv12) || h < 2 || w < 2 || h % 2 ||
      w % 2 || planes < 1 || planes > 65535 || src_pitch < w ||
      vig_pitch < w || vh_pitch < w / 2 || vig_count < 1 || vh_count < 1 ||
      threads > (1LL << 31) - kThreads)
    return (int)cudaErrorInvalidValue;
  const bool vec = w % kSpan == 0 && aligned(src, 8) && src_pitch % 8 == 0 &&
                   src_plane % 8 == 0 && aligned(vig, 16) &&
                   vig_pitch % 4 == 0 && vig_plane % 4 == 0 &&
                   aligned(vh, 16) && vh_pitch % 4 == 0 && vh_plane % 4 == 0 &&
                   aligned(out_y, 8) && aligned(out_uv, 4);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), 1, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* f = (const uint8_t*)src;
  const auto* v = (const float*)vig;
  const auto* c = (const float*)vh;
  if (format == kNv12)
    launch<kNv12>(vec, grid, s, f, src_plane, src_pitch, h, w, v, vig_plane,
                  vig_pitch, vig_count, c, vh_plane, vh_pitch, vh_count,
                  (uint8_t*)out_y, (uint8_t*)out_uv);
  else
    launch<kYuv420p>(vec, grid, s, f, src_plane, src_pitch, h, w, v, vig_plane,
                     vig_pitch, vig_count, c, vh_plane, vh_pitch, vh_count,
                     (uint8_t*)out_y, (uint8_t*)out_uv);
  return (int)cudaGetLastError();
}
