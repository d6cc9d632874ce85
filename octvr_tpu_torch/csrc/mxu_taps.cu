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
//   - taps_fan_kernel: a gather, not the TPU's visit loop, which exists
//     only because Mosaic has no per-element 2-D gather
//     (docs/kernel-notes.md:266-273).  Bound by bytes: per pixel 16 B of
//     plan and a 4 B store, the visited rows once per step.  One block
//     per step: the step's G x 1,024 pixels share one window, so the
//     block copies its visited rows (one contiguous kb x 512 B run of
//     win) into shared memory once, with 16 B cp.async, while its first
//     plan vectors are in flight; each SM's L1 no longer pulls the window
//     in a few sectors per divergent gather.  A thread takes four
//     adjacent pixels of a tile row (one 16 B vector each of oy, l, fx,
//     fy; one 16 B store) in every tile of the step, the next tile's
//     vectors loaded before this tile's gathers; kFanBlocks blocks per SM
//     keep the plan streams in flight.  The four taps of a pixel are
//     shared-memory reads, guarded by row and lane first.  At
//     most kMaxStaged visited rows are staged (56 KB); a wider window
//     takes the same kernel gathering from global memory (L1/L2).
//   - taps_mxu_folded_kernel and taps_mxu_exact2_kernel: every pixel of
//     a step shares its window, so a step is one GEMM, M = the step's
//     G x 1,024 pixels, K = kb visited rows, N = 128 columns, and the
//     horizontal taps are its epilogue (not one product per output row,
//     as on the TPU).  One block per step stages the visited rows once
//     in shared memory as bf16 (exact: integers <= 255), the B operand of
//     wgmma.m64n128k16 (K-major, no swizzle).  Two warpgroups walk the
//     step's M-tiles: 64 pixels for B, 32 for B2, whose tile stacks a
//     pixel's S0 and S1 rows, so each tile is one product and one
//     epilogue.  Each thread builds its A fragments in registers from its
//     pixels' tap rows (the RS form: no one-hot in shared memory, no block
//     barrier per tile).  The products are issued as whole groups (B2: all
//     kb / 16 steps, one wait; B: a step's three terms per group, two
//     fragment sets in turn), since each warpgroup's tiles are short and
//     latency-bound.  The epilogue stages the warp's 16 rows of V in shared
//     memory (B2 as bf16 through stmatrix, exact; B as f32) and each lane of
//     a quad reads one of its pixels' taps; two shuffles sum the quad.
//     One instance per kb / 16 (1..7), so fragments and loops are constant.
//     Bound by the formulation's tensor-core operations, 128 x kb
//     bf16 multiply-adds per pixel and product against 989 TFLOP/s:
//       B2: two products (S0, S1: exact 0/1 selections, f32 accumulate);
//       B:  three: the f32 weight W is split in registers into bf16
//           terms hi + mid + lo (each the rounding of what the ones
//           before it left), the three products accumulate into one f32
//           accumulator: what the TPU's MXU does for an f32 product at
//           HIGHEST, and f32's accuracy, where TF32 would truncate W.
//     At the probe's defaults (kb 48, 15.7 M pixels) those floors are
//     0.390 and 0.585 ms; the function itself needs 0.108 ms of bytes.
//     At most 112 visited rows (ops/mxu_taps.py MAX_VISITED: 28 KB).
// None of them calls a library product.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;             // output rows of a tile
constexpr int kTW = 128;           // lanes: pixels of a row, window columns
constexpr int kTile = kTH * kTW;   // output pixels of a tile
constexpr int kVec = 4;            // the fan's pixels per 16 B plan vector
constexpr int kFanThreads = kTile / kVec;  // the fan's block: a tile per pass
constexpr int kFanBlocks = 4;      // fan blocks resident per SM: <= 64 registers
constexpr int kMaxStaged = 112;    // visited rows the fan stages (56 KB)
constexpr int kWarpgroup = 128;
constexpr int kGroups = 2;         // consumer warpgroups of a product block
constexpr int kProdThreads = kGroups * kWarpgroup;
constexpr int kStepK = 16;         // window rows of one wgmma (K)
constexpr int kMaxVisited = 112;   // ops/mxu_taps.py MAX_VISITED
// The staged window: one K-step (16 rows x 128 columns, bf16) is 4 KB of
// 8 x 8 core matrices; K-adjacent ones lie kLbo apart, N-adjacent kSbo.
constexpr uint32_t kStepBytes = kStepK * kTW * 2;
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = 256;
// The product kernels' epilogue reads the taps from V staged in shared
// memory (B2: bf16 by stmatrix, exact for its integer V; B: f32), each
// warp its own 16 rows, padded to kVRow so the stores meet no bank twice.
constexpr int kVRow = kTW + 8;

struct Pixel {
  int oy0, oy1, l0, l1;
  float fx, fy;
};

// A pixel's plan words as loaded (4 registers); unpacked when used.
struct RawPixel {
  uint32_t oy, l;
  float fx, fy;
};

// Pixels p + 8 i (i < kPx; p = r * 128 + c, past kTile into the next
// tiles) of tile t0 (n * G + g).
template <int kPx>
__device__ __forceinline__ void load_raw(RawPixel (&x)[kPx],
                                         const uint32_t* __restrict__ oyl,
                                         const float* __restrict__ fxy,
                                         int64_t t0, int p) {
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    const int64_t q = (t0 + p / kTile) * 2 * kTile + p % kTile + 8 * i;
    x[i] = {oyl[q], oyl[q + kTile], fxy[q], fxy[q + kTile]};
  }
}

__device__ __forceinline__ Pixel unpack(const RawPixel& r) {
  return {(int)(r.oy & 0xFFFFu), (int)(r.oy >> 16), (int)(r.l & 0xFFFFu),
          (int)(r.l >> 16),      r.fx,              r.fy};
}

// a0 row[l0] + a1 row[l1], a lane outside the 128 adding 0
__device__ __forceinline__ float lane_mix(const int32_t* row, int l0, int l1,
                                          float a0, float a1) {
  const float s0 = l0 < kTW ? (float)row[l0] : 0.0f;
  const float s1 = l1 < kTW ? (float)row[l1] : 0.0f;
  return s0 * a0 + s1 * a1;
}

__device__ __forceinline__ float* out_at(float* out, int n_steps, int64_t n,
                                         int g, int p) {
  return out + ((int64_t)g * n_steps + n) * kTile + p;
}

// Four adjacent pixels' plan words: one 16 B vector of each row kind.
struct PlanVec {
  uint4 oy, l;
  float4 fx, fy;
};

// Pixels p..p+3 of tile t (n * G + g); read once, so streamed past L1.
__device__ __forceinline__ PlanVec load_vec(const uint32_t* __restrict__ oyl,
                                            const float* __restrict__ fxy,
                                            int64_t t, int p) {
  const int64_t q = t * 2 * kTile + p;
  return {__ldcs(reinterpret_cast<const uint4*>(oyl + q)),
          __ldcs(reinterpret_cast<const uint4*>(oyl + q + kTile)),
          __ldcs(reinterpret_cast<const float4*>(fxy + q)),
          __ldcs(reinterpret_cast<const float4*>(fxy + q + kTile))};
}

// One pixel of the fan: rows points at window row klo; a tap row outside
// [klo, klo + kb) adds 0 and is never read.
__device__ __forceinline__ float fan_pixel(const int32_t* rows, int klo, int kb,
                                           uint32_t oy, uint32_t l, float fx,
                                           float fy) {
  const int r0 = (int)(oy & 0xFFFFu) - klo, r1 = (int)(oy >> 16) - klo;
  const int l0 = (int)(l & 0xFFFFu), l1 = (int)(l >> 16);
  const float a0 = 1.0f - fx, a1 = fx;
  float acc = 0.0f;
  if ((unsigned)r0 < (unsigned)kb)
    acc += (1.0f - fy) * lane_mix(rows + r0 * kTW, l0, l1, a0, a1);
  if ((unsigned)r1 < (unsigned)kb)
    acc += fy * lane_mix(rows + r1 * kTW, l0, l1, a0, a1);
  return acc;
}

__device__ __forceinline__ float4 fan_vec(const int32_t* rows, int klo, int kb,
                                          const PlanVec& v) {
  return {fan_pixel(rows, klo, kb, v.oy.x, v.l.x, v.fx.x, v.fy.x),
          fan_pixel(rows, klo, kb, v.oy.y, v.l.y, v.fx.y, v.fy.y),
          fan_pixel(rows, klo, kb, v.oy.z, v.l.z, v.fx.z, v.fy.z),
          fan_pixel(rows, klo, kb, v.oy.w, v.l.w, v.fx.w, v.fy.w)};
}

// Step n's G tiles, gathered from rows (window row klo of step n, in
// shared or global memory): the thread's pixels p..p+3 of each tile, the
// next tile's plan vectors loaded before this tile's gathers.  next holds
// tile 0's on entry.
__device__ __forceinline__ void fan_step(PlanVec next,
                                         const uint32_t* __restrict__ oyl,
                                         const float* __restrict__ fxy,
                                         const int32_t* rows,
                                         float* __restrict__ out, int n_steps,
                                         int G, int klo, int kb, int64_t n,
                                         int p) {
  for (int g = 0; g < G; ++g) {
    const PlanVec cur = next;
    if (g + 1 < G) next = load_vec(oyl, fxy, n * G + g + 1, p);
    __stcs(reinterpret_cast<float4*>(out_at(out, n_steps, n, g, p)),
           fan_vec(rows, klo, kb, cur));
  }
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// One block per step.  kStaged: the visited rows [klo, khi) (kb <=
// kMaxStaged, kb x 512 B of dynamic shared memory) are copied into shared
// memory once, the gathers read them there; else the gathers read win.
template <bool kStaged>
__global__ void __launch_bounds__(kFanThreads, kFanBlocks)
    taps_fan_kernel(const uint32_t* __restrict__ oyl,
                    const float* __restrict__ fxy,
                    const int32_t* __restrict__ win, float* __restrict__ out,
                    int n_steps, int G, int KH, int klo, int khi) {
  extern __shared__ __align__(16) int32_t staged_rows[];
  const int64_t n = blockIdx.x;
  const int kb = khi - klo;
  const int p = kVec * threadIdx.x;
  const int32_t* w = win + (n * KH + klo) * kTW;
  if constexpr (kStaged) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(staged_rows);
    for (int i = threadIdx.x; i < kb * kTW / kVec; i += kFanThreads)
      cp_async16(dst + 16 * i, w + kVec * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const PlanVec first = load_vec(oyl, fxy, n * G, p);
  if constexpr (kStaged) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    fan_step(first, oyl, fxy, staged_rows, out, n_steps, G, klo, kb, n, p);
  } else {
    fan_step(first, oyl, fxy, w, out, n_steps, G, klo, kb, n, p);
  }
}

// ---- the tensor-core bodies ----------------------------------------

// bf16x2 of (lo, hi): lo in the lower half, round to nearest
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Rows [klo, klo + kb) of one step's window (w points at row klo) into
// shared memory as wgmma's B operand (K = kb rows, N = 128 columns), bf16,
// K-major, no swizzle: element (k, c) at byte
//   (k / 16) * 4096 + (c / 8) * 256 + (k / 8 % 2) * 128 + (c % 8) * 16 + (k % 8) * 2,
// i.e. core matrices of 8 columns x 8 rows (16 B per column).  An item is
// one column's 8 rows: 8 loads coalesced across the warp, one 16 B store;
// a quarter warp fills one 128 B core matrix.  The async-proxy fence
// makes the stores visible to wgmma.
__device__ __forceinline__ void stage_window(uint4* rt,
                                             const int32_t* __restrict__ w,
                                             int kb) {
  for (int i = threadIdx.x; i < kb / 8 * kTW; i += kProdThreads) {
    const int c = i % kTW, kc = i / kTW;
    const int32_t* src = w + 8 * kc * kTW + c;
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = pack_bf16x2((float)src[2 * j * kTW], (float)src[(2 * j + 1) * kTW]);
    rt[(kc / 2) * 256 + (c / 8) * 16 + (kc % 2) * 8 + c % 8] =
        make_uint4(h[0], h[1], h[2], h[3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// shared-memory descriptor of one K-step of the staged window
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators after a wait, so no read of them moves above it.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B: A 64 x 16 bf16 from registers (a0..a3, the m16n8k16
// fragment of the thread's warp's 16 rows), B 16 x 128 from the
// descriptor; d += when accumulate, else d =.
__device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b_addr,
                                    bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b_desc(b_addr)),
        "r"((int)accumulate));
}

#undef ACC8

// A fragments.  The thread holds, of its warp's 16 rows of the M-tile,
// rows r0 = lane / 4 and r0 + 8, at the K-step's columns k0 + {0, 1, 8,
// 9} (k0 = the step's first row + 2 (lane % 4)), in four registers:
// {r0, k0..+1}, {r0 + 8, k0..+1}, {r0, k0+8..+9}, {r0 + 8, k0+8..+9}, the
// lower column in the lower half.  d = a tap row - k0.

// 0/1 selection of two columns (k0 + e, k0 + e + 1)
__device__ __forceinline__ uint32_t select2(int d, int e) {
  return (d == e ? 0x3F80u : 0u) | (d == e + 1 ? 0x3F800000u : 0u);
}

// B's f32 weight (1-fy) [oy0 == k] + fy [oy1 == k] of the plain version
__device__ __forceinline__ float weight(int d0, int d1, float wy0, float wy1) {
  return (d0 == 0 ? wy0 : 0.0f) + (d1 == 0 ? wy1 : 0.0f);
}

// Two f32 weights (columns k, k + 1) as three bf16x2 terms: each term is
// the rounding of what the terms before it left, the differences exact
// in f32, so hi + mid + lo holds the f32 weight to ~2^-24 of it.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16x2(x, y);
  x -= __uint_as_float(hi << 16);
  y -= __uint_as_float(hi & 0xFFFF0000u);
  mid = pack_bf16x2(x, y);
  x -= __uint_as_float(mid << 16);
  y -= __uint_as_float(mid & 0xFFFF0000u);
  lo = pack_bf16x2(x, y);
}

// acc = S^T R over the KS K-steps for the 0/1 selection of tap row
// k0 + d0 in row r0 and k0 + d1 in row r0 + 8.  Every step's fragment is
// built first (4 registers a step), then all KS products go out as one
// group with one wait: a wait between steps leaves the warpgroup idle for
// a product's latency.
template <int KS>
__device__ __forceinline__ void select_product(float (&acc)[64], uint32_t rt,
                                               int d0, int d1) {
  uint32_t a[4 * KS];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int e0 = d0 - kStepK * s, e1 = d1 - kStepK * s;
    a[4 * s] = select2(e0, 0);
    a[4 * s + 1] = select2(e1, 0);
    a[4 * s + 2] = select2(e0, 8);
    a[4 * s + 3] = select2(e1, 8);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    mma(acc, a[4 * s], a[4 * s + 1], a[4 * s + 2], a[4 * s + 3],
        rt + s * kStepBytes, s > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// The three terms of one K-step's weights: t[4 m + i] is term m (hi,
// mid, lo) of fragment register i.
__device__ __forceinline__ void folded_frag(uint32_t (&t)[12], const Pixel& p0,
                                            const Pixel& p1, int d) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Pixel& p = (i & 1) ? p1 : p0;
    const int e = d + 8 * (i >> 1);  // column k0 + 8 (i / 2) - the step's offset
    const float wy0 = 1.0f - p.fy, wy1 = p.fy;
    split3(weight(p.oy0 - e, p.oy1 - e, wy0, wy1),
           weight(p.oy0 - e - 1, p.oy1 - e - 1, wy0, wy1), t[i], t[4 + i],
           t[8 + i]);
  }
}

__device__ __forceinline__ void folded_step(float (&acc)[64],
                                            const uint32_t (&t)[12],
                                            uint32_t b_addr, bool accumulate) {
  wgmma_fence();
  mma(acc, t[0], t[1], t[2], t[3], b_addr, accumulate);
  mma(acc, t[4], t[5], t[6], t[7], b_addr, true);
  mma(acc, t[8], t[9], t[10], t[11], b_addr, true);
  wgmma_commit();
}

// acc = W^T R over the KS K-steps, W the f32 weights of pixel p0 (row
// r0) and p1 (row r0 + 8) in three bf16 terms; k0 as above.  Each step's
// three products go out as one group; two fragment sets (12 registers
// each) in turn, a set rebuilt once the group that read it is done.
template <int KS>
__device__ __forceinline__ void folded_product(float (&acc)[64], uint32_t rt,
                                               const Pixel& p0,
                                               const Pixel& p1, int k0) {
  uint32_t a[12], b[12];
#pragma unroll
  for (int s = 0; s < KS; s += 2) {
    if (s > 0) wgmma_wait<1>();
    folded_frag(a, p0, p1, k0 + kStepK * s);
    folded_step(acc, a, rt + s * kStepBytes, s > 0);
    if (s + 1 < KS) {
      if (s > 0) wgmma_wait<1>();
      folded_frag(b, p0, p1, k0 + kStepK * (s + 1));
      folded_step(acc, b, rt + (s + 1) * kStepBytes, true);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// Warp's 16 x 128 tile of V (its accumulator rows) to shared memory as
// bf16, row stride kVRow: 8 stmatrix.x4, each four 8 x 8 matrices (column
// blocks 2 m and 2 m + 1, row blocks 0 and 1); lane gives the address of
// row lane % 8 of matrix lane / 8.
__device__ __forceinline__ void stage_v_bf16(uint32_t vs, const float (&acc)[64],
                                             int lane) {
  const int mi = lane / 8;
  const uint32_t base = vs + ((8 * (mi & 1) + lane % 8) * kVRow + 8 * (mi >> 1)) * 2;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    asm volatile(
        "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
            base + 32 * m),
        "r"(pack_bf16x2(acc[8 * m], acc[8 * m + 1])),
        "r"(pack_bf16x2(acc[8 * m + 2], acc[8 * m + 3])),
        "r"(pack_bf16x2(acc[8 * m + 4], acc[8 * m + 5])),
        "r"(pack_bf16x2(acc[8 * m + 6], acc[8 * m + 7]))
        : "memory");
  }
}

// the same in f32, 8 B stores
__device__ __forceinline__ void stage_v_f32(float* v, const float (&acc)[64],
                                            int lane) {
  float* row = v + (lane / 4) * kVRow + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<float2*>(row + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(row + 8 * kVRow + 8 * j) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Sums the quad's shares of each pixel; lane i of the quad stores pixel i.
template <int kPx>
__device__ __forceinline__ void store_pixels(float* out, int n_steps, int64_t n,
                                             int p, int q, float (&r)[kPx]) {
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 1);
    r[i] += __shfl_xor_sync(0xffffffffu, r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < kPx; ++i)
    if (q == i) *out_at(out, n_steps, n, p / kTile, p % kTile + 8 * i) = r[i];
}

// Shared by both product kernels.  Block n stages step n's window; its
// kGroups warpgroups take the step's M-tiles in turn.  An M-tile's 64
// rows hold 32 kPx pixels: with kPx = 2 a thread's rows r0 and r0 + 8 are
// two pixels (B: one product per pixel), with kPx = 1 one pixel's two
// products (B2: S0 in row r0, S1 in row r0 + 8), so every tile is one
// product and one epilogue.  A tile's plan is loaded a tile ahead.  body(acc, rt, x, k0, lane, vw, r) leaves the
// thread's shares of its pixels' outputs in r (vw: the warp's staging
// rows, Body::kVBytes per element); the window has Body::kSteps K-steps.
template <int kPx, typename Body>
__device__ __forceinline__ void product_step(const uint32_t* __restrict__ oyl,
                                             const float* __restrict__ fxy,
                                             const int32_t* __restrict__ win,
                                             float* __restrict__ out,
                                             int n_steps, int G, int KH,
                                             int klo, Body body) {
  constexpr int kTilePx = 32 * kPx;
  constexpr int kb = Body::kSteps * kStepK;
  extern __shared__ __align__(128) uint4 window_smem[];
  const int64_t n = blockIdx.x;
  stage_window(window_smem, win + (n * KH + klo) * kTW, kb);
  unsigned char* vw = reinterpret_cast<unsigned char*>(window_smem) + kb * kTW * 2 +
                      threadIdx.x / 32 * 16 * kVRow * Body::kVBytes;
  const uint32_t rt = (uint32_t)__cvta_generic_to_shared(window_smem);
  const int lane = threadIdx.x % 32, q = lane % 4;
  const int first = 8 * kPx * (threadIdx.x % kWarpgroup / 32) + lane / 4;
  const int k0 = klo + 2 * q;
  const int tiles = G * (kTile / kTilePx);  // >= 16 >= kGroups
  float acc[64];
  RawPixel cur[kPx], next[kPx];
  int mt = threadIdx.x / kWarpgroup;
  load_raw(cur, oyl, fxy, n * G, mt * kTilePx + first);
  for (; mt < tiles; mt += kGroups) {
    load_raw(next, oyl, fxy, n * G, min(mt + kGroups, tiles - 1) * kTilePx + first);
    Pixel x[kPx];
#pragma unroll
    for (int i = 0; i < kPx; ++i) x[i] = unpack(cur[i]);
    float r[kPx];
    body(acc, rt, x, k0, lane, vw, r);
    store_pixels(out, n_steps, n, mt * kTilePx + first, q, r);
#pragma unroll
    for (int i = 0; i < kPx; ++i) cur[i] = next[i];
  }
}

template <int KS>
struct FoldedBody {  // kPx = 2
  static constexpr int kSteps = KS;
  static constexpr int kVBytes = 4;
  __device__ __forceinline__ void operator()(float (&acc)[64], uint32_t rt,
                                             const Pixel (&x)[2],
                                             int k0, int lane,
                                             unsigned char* vw,
                                             float (&r)[2]) const {
    const int q = lane % 4;
    folded_product<KS>(acc, rt, x[0], x[1], k0);
    // lane q of the quad reads tap q % 2 of pixel q / 2 (row r0 + 8 (q / 2))
    float* v = reinterpret_cast<float*>(vw);
    __syncwarp();  // the last tile's reads are done
    stage_v_f32(v, acc, lane);
    __syncwarp();
    const bool second = q >> 1, right = q & 1;
    const int l = second ? (right ? x[1].l1 : x[1].l0) : (right ? x[0].l1 : x[0].l0);
    const float fx = second ? x[1].fx : x[0].fx;
    const float s = l < kTW ? (right ? fx : 1.0f - fx) *
                                  v[(lane / 4 + 8 * second) * kVRow + l]
                            : 0.0f;
    r[0] = second ? 0.0f : s;
    r[1] = second ? s : 0.0f;
  }
};

template <int KS>
struct Exact2Body {  // kPx = 1
  static constexpr int kSteps = KS;
  static constexpr int kVBytes = 2;
  __device__ __forceinline__ void operator()(float (&acc)[64], uint32_t rt,
                                             const Pixel (&x)[1],
                                             int k0, int lane,
                                             unsigned char* vw,
                                             float (&r)[1]) const {
    const int q = lane % 4;
    select_product<KS>(acc, rt, x[0].oy0 - k0, x[0].oy1 - k0);
    // lane q of the quad reads tap q % 2 of V0 (q < 2, row r0) or V1
    __syncwarp();  // the last tile's reads are done
    stage_v_bf16((uint32_t)__cvta_generic_to_shared(vw), acc, lane);
    __syncwarp();
    const bool v1 = q >> 1, right = q & 1;
    const int l = right ? x[0].l1 : x[0].l0;
    const float w = (v1 ? x[0].fy : 1.0f - x[0].fy) * (right ? x[0].fx : 1.0f - x[0].fx);
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(vw);
    r[0] = l < kTW ? w * __bfloat162float(v[(lane / 4 + 8 * v1) * kVRow + l]) : 0.0f;
  }
};

// One instance per K-step count KS = kb / 16 (1..7), picked at launch, so
// fragments, loops and offsets are constants.
template <int KS>
__global__ void __launch_bounds__(kProdThreads)
    taps_mxu_folded_kernel(const uint32_t* __restrict__ oyl,
                           const float* __restrict__ fxy,
                           const int32_t* __restrict__ win,
                           float* __restrict__ out, int n_steps, int G, int KH,
                           int klo) {
  product_step<2>(oyl, fxy, win, out, n_steps, G, KH, klo, FoldedBody<KS>{});
}

template <int KS>
__global__ void __launch_bounds__(kProdThreads)
    taps_mxu_exact2_kernel(const uint32_t* __restrict__ oyl,
                           const float* __restrict__ fxy,
                           const int32_t* __restrict__ win,
                           float* __restrict__ out, int n_steps, int G, int KH,
                           int klo) {
  product_step<1>(oyl, fxy, win, out, n_steps, G, KH, klo, Exact2Body<KS>{});
}

using ProductKernel = void (*)(const uint32_t*, const float*, const int32_t*,
                               float*, int, int, int, int);
// [KS - 1]: the instance for KS K-steps (kMaxVisited / kStepK = 7)
const ProductKernel kFoldedKernels[] = {
    taps_mxu_folded_kernel<1>, taps_mxu_folded_kernel<2>,
    taps_mxu_folded_kernel<3>, taps_mxu_folded_kernel<4>,
    taps_mxu_folded_kernel<5>, taps_mxu_folded_kernel<6>,
    taps_mxu_folded_kernel<7>};
const ProductKernel kExact2Kernels[] = {
    taps_mxu_exact2_kernel<1>, taps_mxu_exact2_kernel<2>,
    taps_mxu_exact2_kernel<3>, taps_mxu_exact2_kernel<4>,
    taps_mxu_exact2_kernel<5>, taps_mxu_exact2_kernel<6>,
    taps_mxu_exact2_kernel<7>};
static_assert(sizeof(kFoldedKernels) / sizeof(ProductKernel) == kMaxVisited / kStepK,
              "one instance per K-step count");

bool valid(int n_steps, int G, int KH, int klo, int khi) {
  return n_steps > 0 && G > 0 && klo >= 0 && klo < khi && khi <= KH &&
         klo % 16 == 0 && khi % 16 == 0;
}

int launch_per_step(const ProductKernel* kernels, int v_bytes, const void* oyl,
                    const void* fxy, const void* win, void* out, int n_steps,
                    int G, int KH, int klo, int khi, void* stream) {
  if (!valid(n_steps, G, KH, klo, khi) || khi - klo > kMaxVisited)
    return (int)cudaErrorInvalidValue;
  const ProductKernel kernel = kernels[(khi - klo) / kStepK - 1];
  // the window (<= 28 KB) and each warp's staging rows
  const size_t smem = (size_t)(khi - klo) * kTW * 2 +
                      (size_t)kProdThreads / 32 * 16 * kVRow * v_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_steps, kProdThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)oyl, (const float*)fxy, (const int32_t*)win,
      (float*)out, n_steps, G, KH, klo);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points.  Every pointer is a device pointer; stream is a
// cudaStream_t; [klo, khi) are the visited rows, multiples of 16 within
// the window (at most 112 of them for the product kernels); the fan's
// pointers 16 B aligned.  Return: cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue (cudaErrorMisalignedAddress)
// for arguments the kernel does not take.
extern "C" int octvr_taps_fan(const void* oyl, const void* fxy,
                              const void* win, void* out, int n_steps, int G,
                              int KH, int klo, int khi, void* stream) {
  if (!valid(n_steps, G, KH, klo, khi)) return (int)cudaErrorInvalidValue;
  // 16 B plan vectors, window copies and stores
  if (((uintptr_t)oyl | (uintptr_t)fxy | (uintptr_t)win | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // The instance is chosen by shape alone: a window of up to kMaxStaged
  // visited rows is staged in shared memory (kb x 512 B, at most 56 KB);
  // a wider one is gathered from global memory by the same kernel.
  const bool staged = khi - klo <= kMaxStaged;
  const size_t smem = staged ? (size_t)(khi - klo) * kTW * sizeof(int32_t) : 0;
  const auto kernel = staged ? taps_fan_kernel<true> : taps_fan_kernel<false>;
  if (staged) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_steps, kFanThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)oyl, (const float*)fxy, (const int32_t*)win,
      (float*)out, n_steps, G, KH, klo, khi);
  return (int)cudaGetLastError();
}

extern "C" int octvr_taps_mxu_folded(const void* oyl, const void* fxy,
                                     const void* win, void* out, int n_steps,
                                     int G, int KH, int klo, int khi,
                                     void* stream) {
  return launch_per_step(kFoldedKernels, FoldedBody<1>::kVBytes, oyl, fxy,
                         win, out, n_steps, G, KH, klo, khi, stream);
}

extern "C" int octvr_taps_mxu_exact2(const void* oyl, const void* fxy,
                                     const void* win, void* out, int n_steps,
                                     int G, int KH, int klo, int khi,
                                     void* stream) {
  return launch_per_step(kExact2Kernels, Exact2Body<1>::kVBytes, oyl, fxy,
                         win, out, n_steps, G, KH, klo, khi, stream);
}
