// The MXU-taps probe's three bodies (kernel 8 of the TPU table), for
// Hopper (sm_90a).
//
// Replaces, in tools/mxu_taps_probe.py, the three kernel bodies that
// run through one pallas_call (:250):
//   - kern_fan (:100), body A: the production remap fan (a visit loop
//     over the window rows: per row two lane gathers, a one-hot vertical
//     weight, an accumulate): taps_fan_kernel;
//   - kern_mxu (:140), body B: per output row the one-hot vertical
//     weights W[k, pc] = wy0 (oy0 == k) + wy1 (oy1 == k), the f32 product
//     V = W^T R at Precision.HIGHEST, and a two-hot masked lane reduction
//     for the horizontal taps: taps_mxu_folded_kernel;
//   - kern_mxu2 (:197), body B2: two 0/1 selection products S0^T R and
//     S1^T R in bf16 (exact: rows are integers <= 255), the horizontal
//     taps of each, the vertical weights afterwards:
//     taps_mxu_exact2_kernel.
//
// The probe's question is whether the remap's bilinear taps should go
// through the matrix unit instead of a gather.  Every body computes, per
// output pixel,
//   out = (1-fy) (a0 R[oy0][l0] + a1 R[oy0][l1])
//       + fy     (a0 R[oy1][l0] + a1 R[oy1][l1]),   a0 = 1-fx, a1 = fx,
// over the visited window rows [klo, khi) (whole chunks of 16, the fan's
// visit range); a tap outside those rows or the 128 lanes adds 0, as a
// mask that matches nothing does in the matrix bodies.
//
// Layout (ops/mxu_taps.py): N grid steps of G tiles of 8 x 128 output
// pixels.  oyl uint32 [N, G, 16, 128]: rows 0-7 oy0 | oy1 << 16, rows
// 8-15 l0 | l1 << 16; fxy f32 [N, G, 16, 128]: rows 0-7 fx, 8-15 fy;
// win int32 [N, KH, 128], one window per step; out f32 [G, N, 8, 128],
// tile g's output one contiguous [N, 8, 128] slice.
//
// Bounds on this card, and what each design does about them:
//   - taps_fan_kernel: one thread per output pixel with plain loads, as
//     csrc/remap.cu.  The TPU's visit loop exists only because Mosaic has
//     no per-element 2-D gather (docs/kernel-notes.md:266-273); CUDA has
//     one, so each thread reads its 16 B of plan and 4 window values and
//     writes 4 B.  Bound by bytes: the plan, the visited window rows
//     (L2 hits after the first touch: 1,024 pixels share a window) and
//     the store, all coalesced across a warp.
//   - taps_mxu_folded_kernel: one block per step keeps the visited rows
//     in shared memory as f32; per output row it builds W [kb, 128] in
//     shared memory and takes the dense V = W^T R (128 x 128, kb deep) on
//     the CUDA cores in f32, each thread an 8 x 8 register tile (not TF32,
//     which would truncate the weights as the TPU's default precision
//     did).  The horizontal taps are two reads of V in shared memory: the
//     gather the probe meant, where Mosaic needed a masked reduction.
//     Bound by operations: 128 x kb FMAs per output pixel.
//   - taps_mxu_exact2_kernel: one block per step keeps the visited rows
//     in shared memory as bf16; per output row it builds S0 and S1 (bf16
//     0/1) and takes both products on the tensor cores (wmma bf16
//     m16n16k16, f32 accumulation; each of the 8 warps 16 pixels x 128
//     columns), V0 and V1 to shared memory, then the taps.  Bound by
//     operations: 2 x 128 x kb bf16 FMAs per output pixel.  At most 112
//     visited rows fit beside V0 and V1 (ops/mxu_taps.py MAX_VISITED).
// None of them calls a library product.  wgmma and TMA are left for
// later.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kTH = 8;             // output rows of a tile
constexpr int kTW = 128;           // lanes: pixels of a row, window columns
constexpr int kTile = kTH * kTW;   // output pixels of a tile
constexpr int kThreads = 256;
constexpr int kLd = kTW + 8;       // padded row of the exact2 kernel's tiles
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block can use

struct Pixel {
  int oy0, oy1, l0, l1;
  float fx, fy;
};

// pixel p (r * 128 + c) of tile t (n * G + g)
__device__ __forceinline__ Pixel load_pixel(const uint32_t* __restrict__ oyl,
                                            const float* __restrict__ fxy,
                                            int64_t t, int p) {
  const int64_t q = t * 2 * kTile + p;
  const uint32_t oy = oyl[q];
  const uint32_t l = oyl[q + kTile];
  return {(int)(oy & 0xFFFFu), (int)(oy >> 16), (int)(l & 0xFFFFu),
          (int)(l >> 16),      fxy[q],          fxy[q + kTile]};
}

// a0 row[l0] + a1 row[l1], a lane outside the 128 adding 0
template <typename T>
__device__ __forceinline__ float lane_mix(const T* row, int l0, int l1,
                                          float a0, float a1) {
  const float s0 = l0 < kTW ? (float)row[l0] : 0.0f;
  const float s1 = l1 < kTW ? (float)row[l1] : 0.0f;
  return s0 * a0 + s1 * a1;
}

__device__ __forceinline__ float* out_at(float* out, int n_steps, int64_t n,
                                         int g, int p) {
  return out + ((int64_t)g * n_steps + n) * kTile + p;
}

__global__ void __launch_bounds__(kThreads)
    taps_fan_kernel(const uint32_t* __restrict__ oyl,
                    const float* __restrict__ fxy,
                    const int32_t* __restrict__ win, float* __restrict__ out,
                    int n_steps, int G, int KH, int klo, int khi) {
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t t = q / kTile;  // every block lies inside one tile
  const int p = (int)(q % kTile);
  const int64_t n = t / G;
  const int g = (int)(t % G);
  const Pixel px = load_pixel(oyl, fxy, t, p);
  const int32_t* w = win + n * KH * kTW;
  const float a0 = 1.0f - px.fx, a1 = px.fx;
  float acc = 0.0f;
  if (px.oy0 >= klo && px.oy0 < khi)
    acc += (1.0f - px.fy) * lane_mix(w + px.oy0 * kTW, px.l0, px.l1, a0, a1);
  if (px.oy1 >= klo && px.oy1 < khi)
    acc += px.fy * lane_mix(w + px.oy1 * kTW, px.l0, px.l1, a0, a1);
  *out_at(out, n_steps, n, g, p) = acc;
}

// Shared memory (f32): R [kb][128], W [kb][128] (W[k][pc]), V [128][128]
// (V[pc][c]).  Thread t builds column pc = t % 128 of W over every other
// k, computes V's rows 4 ti + {0..3} and 64 + 4 ti + {0..3} at columns
// 4 tj + {0..3} and 64 + 4 tj + {0..3} (ti = t / 16, tj = t % 16: a
// quarter warp reads and writes 128 contiguous bytes), and threads 0-127
// take the taps of pixel pc.
__global__ void __launch_bounds__(kThreads)
    taps_mxu_folded_kernel(const uint32_t* __restrict__ oyl,
                           const float* __restrict__ fxy,
                           const int32_t* __restrict__ win,
                           float* __restrict__ out, int n_steps, int G, int KH,
                           int klo, int kb) {
  extern __shared__ __align__(16) float smem[];
  float* R = smem;
  float* W = R + kb * kTW;
  float* V = W + kb * kTW;
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const int32_t* w = win + (n * KH + klo) * kTW;
  for (int i = tid; i < kb * kTW; i += kThreads) R[i] = (float)w[i];
  const int pc = tid % kTW, half = tid / kTW;
  const int ti = tid / 16, tj = tid % 16;

  for (int row = 0; row < G * kTH; ++row) {
    const int g = row / kTH, r = row % kTH;
    const Pixel px = load_pixel(oyl, fxy, n * G + g, r * kTW + pc);
    const float wy0 = 1.0f - px.fy, wy1 = px.fy;
    for (int k = half; k < kb; k += 2) {
      const int kk = klo + k;
      W[k * kTW + pc] = (px.oy0 == kk ? wy0 : 0.0f) + (px.oy1 == kk ? wy1 : 0.0f);
    }
    __syncthreads();  // W built (and, for the block, the last row's taps read)

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < kb; ++k) {
      const float4 wa = *reinterpret_cast<const float4*>(W + k * kTW + 4 * ti);
      const float4 wb = *reinterpret_cast<const float4*>(W + k * kTW + 64 + 4 * ti);
      const float4 ra = *reinterpret_cast<const float4*>(R + k * kTW + 4 * tj);
      const float4 rb = *reinterpret_cast<const float4*>(R + k * kTW + 64 + 4 * tj);
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], rv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* v = V + ((i < 4 ? 0 : 64) + 4 * ti + (i & 3)) * kTW;
      *reinterpret_cast<float4*>(v + 4 * tj) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(v + 64 + 4 * tj) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();  // V complete

    if (half == 0) {
      *out_at(out, n_steps, n, g, r * kTW + pc) =
          lane_mix(V + pc * kTW, px.l0, px.l1, 1.0f - px.fx, px.fx);
    }
  }
}

// Shared memory: V0, V1 f32 [128][kLd] (pixel, column), then R, S0, S1
// bf16 [kb][kLd] (S[k][pc] = 1 where the pixel's tap row is klo + k);
// rows padded from 128 to kLd = 136 elements, so the 8 rows a fragment
// load or store touches at once fall on different banks.  Warp wp takes
// pixels 16 wp .. 16 wp + 15 against all 128 columns: A = S^T is S read
// column-major (loaded once per k-step for the 8 column tiles), B = R
// row-major, C = V row-major, 8 + 8 accumulator tiles in registers.
// Every wmma pointer is 32-byte aligned.
__global__ void __launch_bounds__(kThreads)
    taps_mxu_exact2_kernel(const uint32_t* __restrict__ oyl,
                           const float* __restrict__ fxy,
                           const int32_t* __restrict__ win,
                           float* __restrict__ out, int n_steps, int G, int KH,
                           int klo, int kb) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* V0 = reinterpret_cast<float*>(smem_raw);
  float* V1 = V0 + kTW * kLd;
  __nv_bfloat16* R = reinterpret_cast<__nv_bfloat16*>(V1 + kTW * kLd);
  __nv_bfloat16* S0 = R + kb * kLd;
  __nv_bfloat16* S1 = S0 + kb * kLd;
  const int tid = threadIdx.x;
  const int64_t n = blockIdx.x;
  const int32_t* w = win + (n * KH + klo) * kTW;
  for (int i = tid; i < kb * kTW; i += kThreads)
    R[i / kTW * kLd + i % kTW] = __float2bfloat16_rn((float)w[i]);
  const int pc = tid % kTW, half = tid / kTW;
  const int wp = tid / 32;
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  for (int row = 0; row < G * kTH; ++row) {
    const int g = row / kTH, r = row % kTH;
    const Pixel px = load_pixel(oyl, fxy, n * G + g, r * kTW + pc);
    for (int k = half; k < kb; k += 2) {
      const int kk = klo + k;
      S0[k * kLd + pc] = px.oy0 == kk ? one : zero;
      S1[k * kLd + pc] = px.oy1 == kk ? one : zero;
    }
    __syncthreads();  // S0, S1 built (and the last row's taps read)

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0[kTW / 16], c1[kTW / 16];
#pragma unroll
    for (int nt = 0; nt < kTW / 16; ++nt) {
      wmma::fill_fragment(c0[nt], 0.0f);
      wmma::fill_fragment(c1[nt], 0.0f);
    }
    for (int kt = 0; kt < kb / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a0, a1;
      wmma::load_matrix_sync(a0, S0 + kt * 16 * kLd + 16 * wp, kLd);
      wmma::load_matrix_sync(a1, S1 + kt * 16 * kLd + 16 * wp, kLd);
#pragma unroll
      for (int nt = 0; nt < kTW / 16; ++nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, R + kt * 16 * kLd + 16 * nt, kLd);
        wmma::mma_sync(c0[nt], a0, b, c0[nt]);
        wmma::mma_sync(c1[nt], a1, b, c1[nt]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTW / 16; ++nt) {
      wmma::store_matrix_sync(V0 + 16 * wp * kLd + 16 * nt, c0[nt], kLd, wmma::mem_row_major);
      wmma::store_matrix_sync(V1 + 16 * wp * kLd + 16 * nt, c1[nt], kLd, wmma::mem_row_major);
    }
    __syncthreads();  // V0, V1 complete

    if (half == 0) {
      const float a0 = 1.0f - px.fx, a1 = px.fx;
      const float h0 = lane_mix(V0 + pc * kLd, px.l0, px.l1, a0, a1);
      const float h1 = lane_mix(V1 + pc * kLd, px.l0, px.l1, a0, a1);
      *out_at(out, n_steps, n, g, r * kTW + pc) = h0 * (1.0f - px.fy) + h1 * px.fy;
    }
  }
}

bool valid(int n_steps, int G, int KH, int klo, int khi) {
  return n_steps > 0 && G > 0 && klo >= 0 && klo < khi && khi <= KH &&
         klo % 16 == 0 && khi % 16 == 0;
}

template <typename Kernel>
int launch_per_step(Kernel kernel, size_t smem, const void* oyl,
                    const void* fxy, const void* win, void* out, int n_steps,
                    int G, int KH, int klo, int khi, void* stream) {
  if (!valid(n_steps, G, KH, klo, khi) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_steps, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)oyl, (const float*)fxy, (const int32_t*)win,
      (float*)out, n_steps, G, KH, klo, khi - klo);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points.  Every pointer is a device pointer; stream is a
// cudaStream_t; [klo, khi) are the visited rows, multiples of 16 within
// the window.  Return: cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int octvr_taps_fan(const void* oyl, const void* fxy,
                              const void* win, void* out, int n_steps, int G,
                              int KH, int klo, int khi, void* stream) {
  if (!valid(n_steps, G, KH, klo, khi)) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)n_steps * G * (kTile / kThreads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  taps_fan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)oyl, (const float*)fxy, (const int32_t*)win,
      (float*)out, n_steps, G, KH, klo, khi);
  return (int)cudaGetLastError();
}

extern "C" int octvr_taps_mxu_folded(const void* oyl, const void* fxy,
                                     const void* win, void* out, int n_steps,
                                     int G, int KH, int klo, int khi,
                                     void* stream) {
  const size_t smem = (size_t)(2 * (khi - klo) + kTW) * kTW * sizeof(float);
  return launch_per_step(taps_mxu_folded_kernel, smem, oyl, fxy, win, out,
                         n_steps, G, KH, klo, khi, stream);
}

extern "C" int octvr_taps_mxu_exact2(const void* oyl, const void* fxy,
                                     const void* win, void* out, int n_steps,
                                     int G, int KH, int klo, int khi,
                                     void* stream) {
  const size_t smem = 2 * (size_t)kTW * kLd * sizeof(float) +
                      3 * (size_t)(khi - klo) * kLd * sizeof(__nv_bfloat16);
  return launch_per_step(taps_mxu_exact2_kernel, smem, oyl, fxy, win, out,
                         n_steps, G, KH, klo, khi, stream);
}
