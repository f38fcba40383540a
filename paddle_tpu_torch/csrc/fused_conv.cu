// Stride-1 VALID NHWC convolution with a fused epilogue, for Hopper
// (sm_90a): y = epilogue(conv(xp, wk)) on a pre-padded plane
// xp [N, Hp, Wp, Ce] and tap-major weights wk [T = Kh * Kw, Ce, O],
// y [N, Ho, Wo, O] with Ho = Hp - Kh + 1, Wo = Wp - Kw + 1.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/fused_conv.py:
//   B10 `_conv_kernel` -> every conv of the ResNet path, after the
//                         wrapper has lowered it to stride 1 (stride 2
//                         as space-to-depth parity planes, the input
//                         gradient as per-parity stride-1 planes of dz)
// with the TPU kernel's three epilogues on the f32 accumulator:
//   none     y = acc
//   moments  y = acc, plus the per-channel sum and sum of squares of
//            the unrounded f32 acc, one partial per M tile ([O, tiles]
//            each; the wrapper sums each channel's row, as the
//            reference sums its (N, 8, O) partials outside the kernel)
//   affine   y = act(acc * g + b [+ residual]), g, b f32 per channel,
//            the residual read in the operand dtype and added in f32,
//            act ReLU or identity
// and y cast once to the operand dtype.
//
// Bound: at ResNet-50's shapes (batch 128, C 12-2048, O 64-2048) the
// 3x3 and wide 1x1 convs do 100-600 operations per byte moved, so the
// tensor cores bound them; the narrow 1x1 ones (C or O 64) sit near the
// byte line. Either way the product is the work.
//
// Design (bf16 and f16: one template on the operand type T, instantiated
// for both, with the same f32 accumulation and the one rounding of y;
// csrc/half16.cuh): an implicit GEMM on warpgroup products (wgmma). M = N *
// Ho * Wo output pixels, the GEMM's N is O, and K = T * Ce is one flat
// axis walked in chunks of 64 (one 128-byte row of a swizzle atom). The
// wrapper pads Ce to a multiple of 8 (zero channels in xp, zero rows in
// wk), so every 8-channel unit of a chunk lies in one tap and is one
// 16-byte cp.async: the unit at K index k reads pixel row
// (n, ho + dh, wo + dw), channels c .. c + 7, with (dh, dw, c) from k. No
// im2col buffer exists in device memory, and the 12-channel stem (16
// padded, K 256) takes 4 chunks. Chunks that the stride-2 lowering
// leaves structurally zero (taps past the kernel's support in some
// parity planes) are skipped: the wrapper passes the list of live
// chunks, and the block walks only those.
//
// A block of two warpgroups owns a tile of 128 pixels x BN outputs (BN
// 64, 128 or 256, chosen from O and K), so x is read once for every BN
// outputs; warpgroup g forms the m64 x BN product of pixels 64 g ..
// from shared memory through descriptors: A [128 pixels][64 K] K-major,
// B the [64 K, BN] slice of wk read MN-major (the transpose bit), both
// in the 128-byte swizzle (16-byte unit u of row r at u ^ (r % 8)). A
// ring of S stages is filled by cp.async S - 2 chunks ahead, while the
// products of the chunk before still run. Convs of K under 1024 (most
// 1x1s) take BN 128 and 3 stages, so two blocks share an SM and one's
// epilogue runs under the other's loads and products.
//
// Epilogue: the f32 accumulators go through the none / moments / affine
// math in registers; y is rounded to T into shared memory and
// written out in 16-byte row vectors, so each warp stores whole lines.
// With a residual the tile stays f32 in shared memory and the row phase
// adds the residual, read in the same 16-byte row vectors, before the
// one rounding.
// The moments are column sums of the unrounded f32 accumulators: each
// thread's two rows of a column are added in registers, the 64 pair
// sums of a column go through shared memory and one thread adds them in
// a fixed order; no atomics, so two launches agree bit for bit (a
// shuffle butterfly over the lanes' rows was slower on an H100). Pixels
// past M and outputs past O are masked (zeros in, no store), so any
// shape is taken.
//
// f32 operands take a CUDA-core path of the same contract (64 x 64
// tiles, 4 x 4 outputs a thread, fmaf in full f32: no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "half16.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using half16::bits_f32;
using half16::pack2;

constexpr int kThreads = 256;     // both paths: two warpgroups (16-bit)
constexpr int kBM = 128;          // output pixels of a block tile (and
                                  // _TILE_M in ops/fused_conv.py)
constexpr int kBK = 64;           // K of a chunk
constexpr uint32_t kAChunk = kBM * 128;   // bytes of a stage's A tile
constexpr int kMaxLive = 512;     // live-chunk list capacity

constexpr int kFM = 64, kFN = 64, kFK = 16;   // CUDA-core tile (kFM:
                                              // _TILE_M too)

enum Epi { kNone = 0, kMoments = 1, kAffine = 2 };

struct Args {
  const void* x;      // xp [N, Hp, Wp, Ce]
  const void* w;      // wk [T, Ce, ldw] (columns past O are zero)
  const float* g;     // affine scale [O]
  const float* b;     // affine shift [O]
  const void* res;    // residual [M, O] (operand dtype) or null
  void* y;            // [M, O], operand dtype
  float* msum;        // moments partials [O, tiles]
  float* msq;
  int tiles;          // M tiles
  int hp, wp, ce, ho, wo, kkh, kkw, o, ldw, m;
  int epi, relu;
  int nlive;          // chunks walked (16-bit): live[0 .. nlive)
  unsigned short live[kMaxLive];
};

// element offset of output pixel m's (dh = 0, dw = 0) input pixel in
// xp, or -1 past M
__device__ __forceinline__ long long pixel_base(const Args& p, int m) {
  if (m >= p.m) return -1;
  const int hw = p.ho * p.wo;
  const int n = m / hw, r = m - n * hw;
  const int oh = r / p.wo, ow = r - oh * p.wo;
  return ((long long)(n * p.hp + oh) * p.wp + ow) * p.ce;
}


// ---------------------------------------------------------------------------
// warpgroup path (bf16 or f16 operands)
// ---------------------------------------------------------------------------

// 16 bytes global -> shared without a register stop; zeros (and no
// read) when !valid
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of 16-byte unit u (0..7) of row r inside a swizzle atom
// row block (rows of 128 bytes)
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * 128 + ((u ^ (r & 7)) << 4);
}

// generic-proxy writes (cp.async) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// d[64 x N] += A B, A K-major and B MN-major (transposed) in shared
// memory; the f32 accumulator of lane (g, t) of warp w: d[4 j + 2 h + e]
// is row 16 w + g + 8 h, column 8 j + 2 t + e
#define FC_WGMMA_N64(TY) \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                             \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                           \
      "%24, %25, %26, %27, %28, %29, %30, %31},"                          \
      " %32, %33, p, 1, 1, 0, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                          \
      : "l"(da), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  if constexpr (half16::kF16<T>)
    FC_WGMMA_N64("f16");
  else
    FC_WGMMA_N64("bf16");
}
#undef FC_WGMMA_N64

#define FC_WGMMA_N128(TY) \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"       \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                             \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                           \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                           \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                           \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                           \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                           \
      "%56, %57, %58, %59, %60, %61, %62, %63},"                          \
      " %64, %65, p, 1, 1, 0, 1;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),  \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),  \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),  \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),  \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                \
      : "l"(da), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  if constexpr (half16::kF16<T>)
    FC_WGMMA_N128("f16");
  else
    FC_WGMMA_N128("bf16");
}
#undef FC_WGMMA_N128

#define FC_WGMMA_N256(TY) \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                        \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                                \
      "%24, %25, %26, %27, %28, %29, %30, %31,"                                \
      "%32, %33, %34, %35, %36, %37, %38, %39,"                                \
      "%40, %41, %42, %43, %44, %45, %46, %47,"                                \
      "%48, %49, %50, %51, %52, %53, %54, %55,"                                \
      "%56, %57, %58, %59, %60, %61, %62, %63,"                                \
      "%64, %65, %66, %67, %68, %69, %70, %71,"                                \
      "%72, %73, %74, %75, %76, %77, %78, %79,"                                \
      "%80, %81, %82, %83, %84, %85, %86, %87,"                                \
      "%88, %89, %90, %91, %92, %93, %94, %95,"                                \
      "%96, %97, %98, %99, %100, %101, %102, %103,"                            \
      "%104, %105, %106, %107, %108, %109, %110, %111,"                        \
      "%112, %113, %114, %115, %116, %117, %118, %119,"                        \
      "%120, %121, %122, %123, %124, %125, %126, %127},"                       \
      " %128, %129, p, 1, 1, 0, 1;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),       \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),       \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),       \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),       \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),       \
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),       \
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),       \
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),       \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),       \
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),       \
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),       \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),  \
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),  \
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),  \
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),  \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),  \
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                               \
      : "l"(da), "l"(db), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  if constexpr (half16::kF16<T>)
    FC_WGMMA_N256("f16");
  else
    FC_WGMMA_N256("bf16");
}
#undef FC_WGMMA_N256

template <int BN, typename T>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (BN == 64) wgmma_n64<T>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<T>(d, da, db);
  else wgmma_n256<T>(d, da, db);
}

template <int BN, int S>
constexpr size_t wg_smem() {
  // alignment slack and the ring of [A 128 x 64 | B 64 x BN] stages; the
  // epilogue reuses the ring (the moments' partial rows [2][64][BN + 8]
  // f32, then the y tile [128][BN + 8], T or f32)
  static_assert(kBM * (BN + 8) * 4 <= S * (kAChunk + BN * 128),
                "the epilogue fits in the ring");
  return 1024 + (size_t)S * (kAChunk + BN * 128);
}

template <int BN, int S, typename T>
__global__ void __launch_bounds__(kThreads, BN == 256 ? 1 : 2)
    wg_conv(const __grid_constant__ Args p) {
  constexpr uint32_t kStage = kAChunk + BN * 128;
  constexpr int VPR = BN / 8;            // 16-byte vectors of a wk row
  constexpr int RPP = kThreads / VPR;    // wk rows a pass of the block
  constexpr int LDY = BN + 8;            // y tile row stride (T)
  constexpr int LDP = BN + 8;            // f32 tile row stride (the
                                         // moments' partials, y with a
                                         // residual)
  static_assert(S >= 3, "the ring refills the stage of two chunks back");

  extern __shared__ uint4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t ring = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB
  char* ring_p = reinterpret_cast<char*>(smem4) + (ring - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  // O tiles of one M tile are neighbours in launch order, so the blocks
  // that run together share their x rows
  const int n_ot = (p.o + BN - 1) / BN;
  const int mt = blockIdx.x / n_ot, ot = blockIdx.x - mt * n_ot;
  const int m0 = mt * kBM, o0 = ot * BN;
  const int K = p.kkh * p.kkw * p.ce;
  const T* X = static_cast<const T*>(p.x);
  const T* W = static_cast<const T*>(p.w);

  // this thread's A copies: unit u of rows (tid >> 3) + 32 j
  const int u = tid & 7, r0 = tid >> 3;
  long long rb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) rb[j] = pixel_base(p, m0 + r0 + 32 * j);

  // chunk i of the walk into stage i % S; one commit group of every
  // thread, whatever it copies
  auto load = [&](int i) {
    if (i < p.nlive) {
      const int kc = p.live[i];
      const uint32_t st = ring + (i % S) * kStage;
      const int k = kc * kBK + u * 8;
      long long off = 0;
      if (k < K) {
        const int t = k / p.ce, c = k - t * p.ce;
        const int dh = t / p.kkw, dw = t - dh * p.kkw;
        off = ((long long)dh * p.wp + dw) * p.ce + c;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k < K && rb[j] >= 0;
        cp_async16_s(st + swz(r0 + 32 * j, u), X + (ok ? rb[j] + off : 0),
                     ok);
      }
      const int v = tid % VPR;
#pragma unroll
      for (int kr = tid / VPR; kr < kBK; kr += RPP) {
        const int row = kc * kBK + kr;
        const bool ok = row < K && o0 + v * 8 < p.ldw;
        cp_async16_s(st + kAChunk + (v >> 3) * 8192 + swz(kr, v & 7),
                     W + (ok ? (size_t)row * p.ldw + o0 + v * 8 : 0), ok);
      }
    }
    cp_async_commit();
  };

  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 2; ++i) load(i);
  for (int i = 0; i < p.nlive; ++i) {
    cp_async_wait<S - 3>();   // chunk i has landed (this thread's part)
    fence_async_smem();
    __syncthreads();          // ... every thread's; the products of
                              // chunk i - 2 are done in both warpgroups
    const uint32_t st = ring + (i % S) * kStage;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_bn<BN, T>(acc, wg_desc(st + wg * 64 * 128 + kk * 32, 16, 1024),
                   wg_desc(st + kAChunk + kk * 16 * 128, 8192, 1024));
    wg_commit();
    wg_wait<1>();             // this warpgroup's products of chunk i - 1
    load(i + S - 2);          // into the stage of chunk i - 2
  }
  wg_wait<0>();
  reg_fence(acc);
  cp_async_wait<0>();         // the empty groups past the last chunk
  __syncthreads();            // the ring is free for the epilogue

  const int rw = wg * 64 + warp * 16 + g;   // + 8 h: the thread's rows
  if (p.epi == kMoments) {
    // column sums of the unrounded acc over the tile's 128 rows (rows
    // past M hold exact zeros): each thread adds its two rows of a
    // column and stores the pair's sum and sum of squares as one of 64
    // partial rows (rows padded by 8 floats, so at most two of a warp's
    // stores share a bank); then one thread a (quantity, column) adds
    // the 64 in order
    float* part = reinterpret_cast<float*>(ring_p);   // [2][64][LDP]
    const int pr = (wg * 4 + warp) * 8 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a0 = acc[4 * j + e], a1 = acc[4 * j + 2 + e];
        const int col = 8 * j + 2 * t4 + e;
        part[pr * LDP + col] = a0 + a1;
        part[(64 + pr) * LDP + col] = a0 * a0 + a1 * a1;
      }
    __syncthreads();
    for (int i = tid; i < 2 * BN; i += kThreads) {
      const int q = i / BN, col = i - q * BN;
      float sum = 0.f;
#pragma unroll 16
      for (int r = 0; r < 64; ++r) sum += part[(q * 64 + r) * LDP + col];
      if (o0 + col < p.o)
        (q ? p.msq : p.msum)[(size_t)(o0 + col) * p.tiles + mt] = sum;
    }
    __syncthreads();          // the y tile below reuses the partials' space
  }

  // y through the epilogue into the tile: rounded to T, or, with a
  // residual, acc * g + b kept in f32, so that the row phase below adds
  // the residual (read in whole 16-byte rows) before the one rounding
  const bool res_rows = p.epi == kAffine && p.res != nullptr;
  T* ys = reinterpret_cast<T*>(ring_p);
  float* yf = reinterpret_cast<float*>(ring_p);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t4, c = o0 + col;
    float ga[2] = {1.f, 1.f}, ba[2] = {0.f, 0.f};
    if (p.epi == kAffine) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c + e < p.o) {
          ga[e] = p.g[c + e];
          ba[e] = p.b[c + e];
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = acc[4 * j + 2 * h + e];
        if (p.epi == kAffine) {
          v[e] = v[e] * ga[e] + ba[e];
          if (p.relu && !res_rows) v[e] = fmaxf(v[e], 0.f);
        }
      }
      if (res_rows)
        *reinterpret_cast<float2*>(yf + r * LDP + col) = make_float2(v[0], v[1]);
      else
        *reinterpret_cast<uint32_t*>(ys + r * LDY + col) =
            pack2<T>(v[0], v[1]);
    }
  }
  __syncthreads();
  // whole rows out: a warp stores 32 consecutive 16-byte vectors
  T* y = static_cast<T*>(p.y);
  const T* res = static_cast<const T*>(p.res);
  const bool vec = p.o % 8 == 0;
  for (int i = tid; i < kBM * VPR; i += kThreads) {
    const int r = i / VPR, col = (i - r * VPR) * 8;
    const int m = m0 + r, c = o0 + col;
    if (m >= p.m || c >= p.o) continue;
    const size_t at = (size_t)m * p.o + c;
    const int n8 = vec ? 8 : min(8, p.o - c);
    uint32_t ow[4];   // the 8 outputs, T pairs
    if (res_rows) {
      const float4* src = reinterpret_cast<const float4*>(yf + r * LDP + col);
      const float4 lo = src[0], hi = src[1];
      const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      uint32_t rr[4] = {0u, 0u, 0u, 0u};   // the residual, T pairs
      if (vec) {
        const uint4 q = *reinterpret_cast<const uint4*>(res + at);
        rr[0] = q.x, rr[1] = q.y, rr[2] = q.z, rr[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < n8)
            rr[e / 2] |= (uint32_t)reinterpret_cast<const uint16_t*>(
                             res)[at + e] << (16 * (e & 1));
      }
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        // T -> f32 is exact
        float a0 = v[e] + bits_f32<T>(rr[e / 2] & 0xffffu);
        float a1 = v[e + 1] + bits_f32<T>(rr[e / 2] >> 16);
        if (p.relu) {
          a0 = fmaxf(a0, 0.f);
          a1 = fmaxf(a1, 0.f);
        }
        ow[e / 2] = pack2<T>(a0, a1);
      }
    } else {
      const uint4 q = *reinterpret_cast<const uint4*>(ys + r * LDY + col);
      ow[0] = q.x, ow[1] = q.y, ow[2] = q.z, ow[3] = q.w;
    }
    if (vec) {
      *reinterpret_cast<uint4*>(y + at) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < n8)
          reinterpret_cast<uint16_t*>(y)[at + e] =
              (uint16_t)(ow[e / 2] >> (16 * (e & 1)));
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32 operands, full f32)
// ---------------------------------------------------------------------------

struct F32Smem {
  float a[kFK][kFM + 4];          // A tile, K-major: a[k][row]
  float b[kFK][kFN];              // B tile: b[k][col]
  long long rows[kFM];
  float red[2][16][kFN];          // moments: per row-group column sums
};

// the f32 epilogue of one output element (row m < M, column c < O)
__device__ __forceinline__ float epilogue(const Args& p, float acc, int m,
                                          int c) {
  float v = acc;
  if (p.epi == kAffine) {
    v = v * p.g[c] + p.b[c];
    if (p.res) v += static_cast<const float*>(p.res)[(size_t)m * p.o + c];
    if (p.relu) v = fmaxf(v, 0.f);
  }
  return v;
}

// thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of the 64 x 64 tile
__global__ void __launch_bounds__(kThreads) f32_conv(const Args p) {
  __shared__ __align__(16) F32Smem s;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.x * kFM, o0 = blockIdx.y * kFN;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  for (int r = threadIdx.x; r < kFM; r += kThreads)
    s.rows[r] = pixel_base(p, m0 + r);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nck = (p.ce + kFK - 1) / kFK;
  const int nk = p.kkh * p.kkw * nck;
  for (int ks = 0; ks < nk; ++ks) {
    const int t = ks / nck, c0 = (ks - t * nck) * kFK;
    const int dh = t / p.kkw, dw = t - dh * p.kkw;
    const long long tap = ((long long)dh * p.wp + dw) * p.ce + c0;
    __syncthreads();      // the rows are set; the last step is consumed
#pragma unroll
    for (int j = 0; j < kFM * kFK / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int r = e / kFK, k = e % kFK;
      const long long base = s.rows[r];
      s.a[k][r] = (base >= 0 && c0 + k < p.ce) ? x[base + tap + k] : 0.f;
    }
    const long long wrow = (long long)t * p.ce + c0;
#pragma unroll
    for (int j = 0; j < kFK * kFN / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int k = e / kFN, c = e % kFN;
      s.b[k][c] = (c0 + k < p.ce && o0 + c < p.o)
                      ? w[(wrow + k) * p.o + o0 + c]
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.b[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  if (p.epi == kMoments) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s1 += acc[i][j];
        s2 += acc[i][j] * acc[i][j];
      }
      s.red[0][ty][tx + 16 * j] = s1;
      s.red[1][ty][tx + 16 * j] = s2;
    }
    __syncthreads();
    if (threadIdx.x < kFN && o0 + threadIdx.x < p.o) {
      const int c = threadIdx.x;
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < 16; ++r) {
        s1 += s.red[0][r][c];
        s2 += s.red[1][r][c];
      }
      const size_t at = (size_t)(o0 + c) * p.tiles + blockIdx.x;
      p.msum[at] = s1;
      p.msq[at] = s2;
    }
  }

  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = o0 + tx + 16 * j;
      if (c < p.o) y[(size_t)m * p.o + c] = epilogue(p, acc[i][j], m, c);
    }
  }
}

// BN and stages of a 16-bit launch: 256 outputs a tile where O is wide and
// K long (16 chunks or more: one block an SM, a 4-stage ring), 128 for
// shorter K (two blocks an SM, a 3-stage ring), 64 where O is 64
struct Cfg {
  void (*fn)(const Args);
  size_t bytes;
  int bn;
};

template <int BN, int S>
Cfg cfg(int dtype) {
  if (dtype == 2) return {wg_conv<BN, S, __half>, wg_smem<BN, S>(), BN};
  return {wg_conv<BN, S, __nv_bfloat16>, wg_smem<BN, S>(), BN};
}

// dtype 1 (bf16) or 2 (f16)
Cfg tile(int bn, int dtype) {
  switch (bn) {
    case 64: return cfg<64, 4>(dtype);
    case 128: return cfg<128, 3>(dtype);
    default: return cfg<256, 4>(dtype);
  }
}

// nk: the chunks walked
Cfg pick(int o, int nk, int dtype) {
  return tile(o <= 64 ? 64 : (o <= 128 || nk < 16 ? 128 : 256), dtype);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16 (xp, wk, residual and y share it). epi: 0
// none, 1 moments (msum, msq [O, tiles] f32; tiles = ceil(M / kBM) in
// 16 bits, ceil(M / kFM) in f32), 2 affine (g, b f32 [O]; residual
// [M, O] or null; relu 0 / 1). xp [N, Hp, Wp, Ce], wk [kkh * kkw, Ce,
// ldw] (ldw >= O; 16 bits: Ce and ldw multiples of 8, the columns past
// O zero), y [N, Hp - kkh + 1, Wp - kkw + 1, O], all contiguous; 16-bit
// pointers 16-byte aligned. live: the nlive (1 .. 512) K chunks of 64
// that the 16-bit path walks, in order (f32 ignores it). Returns cudaGetLastError() of the
// launch.
extern "C" int fused_conv(int dtype, int epi, int relu, const void* xp,
                          const void* wk, const float* g, const float* b,
                          const void* res, void* y, float* msum, float* msq,
                          int n, int hp, int wp, int ce, int kkh, int kkw,
                          int o, int ldw, const unsigned short* live,
                          int nlive, int num_sms, void* stream) {
  (void)num_sms;
  if (dtype < 0 || dtype > 2 || epi < 0 || epi > 2 || n <= 0 || ce <= 0 ||
      o <= 0 || ldw < o ||
      kkh <= 0 || kkw <= 0 || hp < kkh || wp < kkw)
    return cudaErrorInvalidValue;
  Args p;
  p.x = xp;
  p.w = wk;
  p.g = g;
  p.b = b;
  p.res = res;
  p.y = y;
  p.msum = msum;
  p.msq = msq;
  p.hp = hp;
  p.wp = wp;
  p.ce = ce;
  p.ho = hp - kkh + 1;
  p.wo = wp - kkw + 1;
  p.kkh = kkh;
  p.kkw = kkw;
  p.o = o;
  p.ldw = ldw;
  const long long m = (long long)n * p.ho * p.wo;
  if (m >= (1LL << 31)) return cudaErrorInvalidValue;
  p.m = (int)m;
  p.epi = epi;
  p.relu = relu;
  p.tiles = (p.m + (dtype ? kBM : kFM) - 1) / (dtype ? kBM : kFM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dtype) {
    if (ldw != o) return cudaErrorInvalidValue;
    const dim3 grid((p.m + kFM - 1) / kFM, (o + kFN - 1) / kFN);
    f32_conv<<<grid, kThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (ce % 8 || ldw % 8) return cudaErrorInvalidValue;
  const long long k = (long long)kkh * kkw * ce;
  const int nk = (int)((k + kBK - 1) / kBK);
  if (!live || nlive <= 0 || nlive > kMaxLive) return cudaErrorInvalidValue;
  p.nlive = nlive;
  for (int i = 0; i < nlive; ++i) {
    if (live[i] >= nk) return cudaErrorInvalidValue;
    p.live[i] = live[i];
  }
  const Cfg c = pick(o, nlive, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)((p.m + kBM - 1) / kBM) * ((o + c.bn - 1) / c.bn);
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  c.fn<<<(unsigned)blocks, kThreads, c.bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// what fused_conv launches in bf16 (dtype 1) or f16 (2) for tiles of
// tile_n (64, 128, 256) outputs: registers and local (spilled) bytes a
// thread, threads and shared bytes a block, and the blocks an SM holds
// at once
extern "C" int fused_conv_occupancy(int tile_n, int dtype, int* out) {
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  const Cfg c = tile(tile_n, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      c.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, c.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], c.fn,
                                                        kThreads, c.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = static_cast<int>(c.bytes);
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
