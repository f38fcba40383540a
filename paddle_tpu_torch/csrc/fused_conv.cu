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
//            the unrounded f32 acc, one partial row per M tile
//            ([tiles, O] each; the wrapper sums the rows, as the
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
// Design: an implicit GEMM. M = N * Ho * Wo output pixels, the GEMM's N
// is O, K = T * Ce walked tap by tap and, within a tap, in chunks of 32
// channels. A block owns a 128 x 64 tile of y and walks K; for each
// step it gathers the 128 shifted pixel rows of xp (a row is the pixel
// (n, ho + dh, wo + dw): Ce contiguous channels) and the [32, 64] slice
// of wk into shared memory. No im2col buffer exists in device memory.
// The row offsets of the tile's pixels are computed once per block. A
// 2-stage ring of tiles is filled with cp.async (16-byte vectors where
// Ce, resp. O, is a multiple of 8; element loads otherwise, such as
// the 12-channel space-to-depth stem) while the other stage feeds the
// tensor cores: mma.sync.m16n8k16, bf16 in, f32 accumulators (the
// reference's arithmetic), A fragments by ldmatrix, B fragments by
// ldmatrix.trans from the O-contiguous weight tile. Eight warps split
// the block tile 4 (M) x 2 (O) into 32 x 32 warp tiles. Pixels past M,
// channels past Ce and outputs past O are masked (zeros in, no store),
// so any shape is taken. Moments come out of the registers: a shuffle
// reduction over the rows a warp holds, then a fixed-order sum over
// the 4 M-warps in shared memory; no atomics, so two launches agree
// bit for bit. f32 operands take a CUDA-core path of the same shape
// (64 x 64 tiles, 4 x 4 outputs a thread, fmaf in full f32: no TF32).
// Shared-memory rows are padded by 16 bytes so fragment loads fall on
// distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;          // output pixels of a block tile (and
                                  // _TILE_M in ops/fused_conv.py)
constexpr int kBN = 64;           // output channels of a block tile
constexpr int kBK = 32;           // channels of one K step
constexpr int kLDA = kBK + 8;     // A tile row stride (bf16): 80 bytes
constexpr int kLDB = kBN + 8;     // B tile row stride (bf16): 144 bytes

constexpr int kFM = 64, kFN = 64, kFK = 16;   // CUDA-core tile (kFM:
                                              // _TILE_M too)

enum Epi { kNone = 0, kMoments = 1, kAffine = 2 };

struct Args {
  const void* x;      // xp [N, Hp, Wp, Ce]
  const void* w;      // wk [T, Ce, O]
  const float* g;     // affine scale [O]
  const float* b;     // affine shift [O]
  const void* res;    // residual [M, O] (operand dtype) or null
  void* y;            // [M, O], operand dtype
  float* msum;        // moments partials [tiles, O]
  float* msq;
  int hp, wp, ce, ho, wo, kkh, kkw, o, m;
  int epi, relu;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// element offset of output pixel m's (dh = 0, dw = 0) input pixel in
// xp, or -1 past M
__device__ __forceinline__ long long pixel_base(const Args& p, int m) {
  if (m >= p.m) return -1;
  const int hw = p.ho * p.wo;
  const int n = m / hw, r = m - n * hw;
  const int oh = r / p.wo, ow = r - oh * p.wo;
  return ((long long)(n * p.hp + oh) * p.wp + ow) * p.ce;
}

// the epilogue of one output element (row m < M, column c < O)
template <typename T>
__device__ __forceinline__ float epilogue(const Args& p, float acc, int m,
                                          int c) {
  float v = acc;
  if (p.epi == kAffine) {
    v = v * p.g[c] + p.b[c];
    if (p.res)
      v += to_f(static_cast<const T*>(p.res)[(size_t)m * p.o + c]);
    if (p.relu) v = fmaxf(v, 0.f);
  }
  return v;
}

// ---------------------------------------------------------------------------
// tensor-core path (bf16 operands)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared without a register stop; zeros (and no
// read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct TcSmem {
  __nv_bfloat16 a[2][kBM * kLDA];
  __nv_bfloat16 b[2][kBK * kLDB];
  long long rows[kBM];            // pixel_base of the tile's rows
  float red[2][4][kBN];           // moments: per M-warp column sums
};

// Fill stage `st` with K step `ks`: the A tile (the tile's pixel rows,
// shifted by the step's tap, channels c0 .. c0 + 31) and the B tile
// (wk rows t * Ce + c0 .., columns o0 .. o0 + 63). AVEC / BVEC: Ce /
// O is a multiple of 8, so a row chunk of 8 is one 16-byte vector.
template <bool AVEC, bool BVEC>
__device__ __forceinline__ void tc_fetch(TcSmem& s, const Args& p, int st,
                                         int ks, int nck, int o0) {
  const int t = ks / nck, c0 = (ks - t * nck) * kBK;
  const int dh = t / p.kkw, dw = t - dh * p.kkw;
  const long long tap = ((long long)dh * p.wp + dw) * p.ce + c0;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  __nv_bfloat16* As = s.a[st];
  __nv_bfloat16* Bs = s.b[st];
  if constexpr (AVEC) {
#pragma unroll
    for (int j = 0; j < kBM * kBK / 8 / kThreads; ++j) {
      const int v = threadIdx.x + j * kThreads;
      const int r = v >> 2, cv = (v & 3) * 8;
      const long long base = s.rows[r];
      const bool ok = base >= 0 && c0 + cv < p.ce;
      cp_async16(As + r * kLDA + cv, x + (ok ? base + tap + cv : 0), ok);
    }
  } else {
    const int c = threadIdx.x & (kBK - 1);
    const bool cok = c0 + c < p.ce;
#pragma unroll 4
    for (int r = threadIdx.x / kBK; r < kBM; r += kThreads / kBK) {
      const long long base = s.rows[r];
      As[r * kLDA + c] = (base >= 0 && cok) ? x[base + tap + c]
                                            : __float2bfloat16(0.f);
    }
  }
  const long long wrow = (long long)t * p.ce + c0;
  if constexpr (BVEC) {
    const int r = threadIdx.x >> 3, cv = (threadIdx.x & 7) * 8;
    const bool ok = c0 + r < p.ce && o0 + cv < p.o;
    cp_async16(Bs + r * kLDB + cv,
               w + (ok ? (wrow + r) * p.o + o0 + cv : 0), ok);
  } else {
    const int c = threadIdx.x & (kBN - 1);
    const bool cok = o0 + c < p.o;
#pragma unroll
    for (int r = threadIdx.x / kBN; r < kBK; r += kThreads / kBN)
      Bs[r * kLDB + c] = (cok && c0 + r < p.ce)
                             ? w[(wrow + r) * p.o + o0 + c]
                             : __float2bfloat16(0.f);
  }
}

template <bool AVEC, bool BVEC>
__global__ void __launch_bounds__(kThreads) tc_conv(const Args p) {
  __shared__ __align__(16) TcSmem s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;   // 4 x 2 warps of 32 x 32
  const int m0 = blockIdx.x * kBM, o0 = blockIdx.y * kBN;

  for (int r = threadIdx.x; r < kBM; r += kThreads)
    s.rows[r] = pixel_base(p, m0 + r);
  __syncthreads();

  const int nck = (p.ce + kBK - 1) / kBK;
  const int nk = p.kkh * p.kkw * nck;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;

  tc_fetch<AVEC, BVEC>(s, p, 0, 0, nck, o0);
  cp_async_commit();
  for (int ks = 0; ks < nk; ++ks) {
    const int st = ks & 1;
    if (ks + 1 < nk) tc_fetch<AVEC, BVEC>(s, p, st ^ 1, ks + 1, nck, o0);
    cp_async_commit();    // possibly empty: every thread counts alike
    cp_async_wait<1>();   // step ks has landed
    __syncthreads();
    const __nv_bfloat16* As = s.a[st];
    const __nv_bfloat16* Bs = s.b[st];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * kLDA + kk +
                           (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, Bs + (kk + (lane & 15)) * kLDB + wn * 32 + jp * 16 +
                             (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * jp], a[mi], b);
          mma_bf16(acc[mi][2 * jp + 1], a[mi], b + 2);
        }
      }
    }
    __syncthreads();      // every warp is done with stage st
  }
  cp_async_wait<0>();

  if (p.epi == kMoments) {
    // column sums over the warp's 32 rows (rows past M hold exact 0),
    // then over the 4 M-warps in a fixed order
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[mi][j][2 * h + e];
            s1 += v;
            s2 += v * v;
          }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          s2 += __shfl_xor_sync(0xffffffffu, s2, off);
        }
        if (g == 0) {
          const int c = wn * 32 + j * 8 + 2 * t4 + e;
          s.red[0][wm][c] = s1;
          s.red[1][wm][c] = s2;
        }
      }
    __syncthreads();
    if (threadIdx.x < kBN && o0 + threadIdx.x < p.o) {
      const int c = threadIdx.x;
      const size_t at = (size_t)blockIdx.x * p.o + o0 + c;
      p.msum[at] = ((s.red[0][0][c] + s.red[0][1][c]) + s.red[0][2][c]) +
                   s.red[0][3][c];
      p.msq[at] = ((s.red[1][0][c] + s.red[1][1][c]) + s.red[1][2][c]) +
                  s.red[1][3][c];
    }
  }

  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const bool pairs = (p.o & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mi * 16 + g + 8 * h;
      if (m >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = o0 + wn * 32 + j * 8 + 2 * t4;
        if (c >= p.o) continue;
        const float v0 = epilogue<__nv_bfloat16>(p, acc[mi][j][2 * h], m, c);
        if (pairs) {   // c even, O even: c + 1 < O and 4-byte aligned
          const float v1 =
              epilogue<__nv_bfloat16>(p, acc[mi][j][2 * h + 1], m, c + 1);
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * p.o + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          y[(size_t)m * p.o + c] = __float2bfloat16(v0);
          if (c + 1 < p.o)
            y[(size_t)m * p.o + c + 1] = __float2bfloat16(
                epilogue<__nv_bfloat16>(p, acc[mi][j][2 * h + 1], m, c + 1));
        }
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
      const size_t at = (size_t)blockIdx.x * p.o + o0 + c;
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
      if (c < p.o) y[(size_t)m * p.o + c] = epilogue<float>(p, acc[i][j], m, c);
    }
  }
}

template <bool AVEC, bool BVEC>
cudaError_t launch_tc(const Args& p, cudaStream_t st) {
  const dim3 grid((p.m + kBM - 1) / kBM, (p.o + kBN - 1) / kBN);
  tc_conv<AVEC, BVEC><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16 (xp, wk, residual and y share it). epi: 0 none,
// 1 moments (msum, msq [tiles, O] f32; tiles = ceil(M / kBM) in bf16,
// ceil(M / kFM) in f32), 2 affine (g, b f32 [O];
// residual [M, O] or null; relu 0 / 1). xp [N, Hp, Wp, Ce], wk
// [kkh * kkw, Ce, O], y [N, Hp - kkh + 1, Wp - kkw + 1, O], all
// contiguous; bf16 pointers 16-byte aligned. Returns
// cudaGetLastError() of the launch.
extern "C" int fused_conv(int dtype, int epi, int relu, const void* xp,
                          const void* wk, const float* g, const float* b,
                          const void* res, void* y, float* msum, float* msq,
                          int n, int hp, int wp, int ce, int kkh, int kkw,
                          int o, int num_sms, void* stream) {
  (void)num_sms;
  if (epi < 0 || epi > 2 || n <= 0 || ce <= 0 || o <= 0 || kkh <= 0 ||
      kkw <= 0 || hp < kkh || wp < kkw)
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
  const long long m = (long long)n * p.ho * p.wo;
  if (m >= (1LL << 31)) return cudaErrorInvalidValue;
  p.m = (int)m;
  p.epi = epi;
  p.relu = relu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!dtype) {
    const dim3 grid((p.m + kFM - 1) / kFM, (o + kFN - 1) / kFN);
    f32_conv<<<grid, kThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const bool avec = ce % 8 == 0, bvec = o % 8 == 0;
  cudaError_t err;
  if (avec && bvec) err = launch_tc<true, true>(p, st);
  else if (avec) err = launch_tc<true, false>(p, st);
  else if (bvec) err = launch_tc<false, true>(p, st);
  else err = launch_tc<false, false>(p, st);
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
