// w8a8_matmul for Hopper (sm_90a):
//   qa[m, k] = int8(clip(rint(x[m, k] * (127 / sa)), -127, 127))
//   out[m, n] = float(sum_k int32(qa[m, k]) * int32(qb[k, n]))
//               * (sa * sb / (127 * 127))
// x [M, K] f32 (row stride ldx), qb a logical [K, N] int8 table read in
// place through element strides (sk, sn) — the serving engine passes
// the transpose of its [N, K] frozen embedding table (sk = 1, sn = K),
// which is never copied — sa and sb per-tensor f32 scales read from
// device memory (no host sync), out [M, N] f32 contiguous.
//
// Replaces the Pallas TPU kernel `_w8a8_kernel` of paddle_tpu/ops/lowp.py
// (reached through `_w8a8_pallas` -> `_pallas_mm`, public `w8a8_matmul`):
// the w8a8 serving engine's tied LM head.
//
// Bound: device-memory bytes (the 38.6 MB int8 table at the serving
// shape M = 8, K = 768, N = 50304, read once; 2*M int ops per byte).
// Design (`w8a8_stream`): the table streams through shared memory as
// table_stream.cuh describes (TMA into an mbarrier ring of ten 16 KB
// slots, one block an SM: one producer warp, four consumer warps of 32
// table rows), and each slot is
// multiplied with mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores:
// table rows (the columns n of qb) are the m16 side, the quantized x rows
// the n8 side, and the table's bytes enter the products as they are. The
// block quantizes its x tile (8 or 16 rows) into shared memory once (per K
// segment when it does not fit): rintf = round half to even, like
// jnp.round; 127/sa and the epilogue factor by IEEE division, no
// fast-math; NaN gives code 0, as the plain version's nan_to_num. The
// int32 sums are exact (|acc| <= 127^2 K < 2^31), so the result is
// bitwise equal to the plain version in any order, and repeats. The
// engine's K-major table (sk = 1, a row stride of a multiple of 16
// bytes) arrives by TMA; any other layout, the MN-major [K, N] one
// included, by the producer warp's byte loads into the same ring (slower;
// no caller of the engine passes one). Ragged M, N and K edges are
// masked, never padded.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "sm90.cuh"
#include "table_stream.cuh"

namespace w8a8 {

using namespace tstream;

constexpr int kXBudget = 32 * 1024;   // staged x bytes (one a value)
constexpr int kStages = 10;           // ring slots: 160 KB in flight an SM

struct Args {
  Table t;
  const float* x;
  long long ldx;
  int M;
  const float* sa;
  const float* sb;
  float* out;
  int ks_seg;
  int tma;
};

// byte offset of x[r][kl] inside the staged segment: lane (g, t) of n8
// group r / 8 reads 16 bytes of K order permuted as the table's
// (table_stream.cuh): physical k 32 t + 16 i + e of each 128-byte step
template <int NG>
__device__ __forceinline__ int x_off(int r, int kl) {
  const int kb = kl >> 7, w = kl & 127;
  const int t = w >> 5, i = (w & 31) >> 4, e = w & 15;
  return ((kb * 2 + i) * NG + (r >> 3)) * 512 + (4 * (r & 7) + t) * 16 + e;
}

__device__ __forceinline__ uint32_t quant(float v, float inv) {
  v = rintf(v * inv);
  v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
  if (v != v) return 0u;
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(v)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NG>
struct Op {
  static constexpr int kR = 8 * NG;      // x rows of the block
  static constexpr int kRW = kR / kWarps;   // of them, this warp's
  static constexpr int kUK = 48 / kRW;   // a row's values a lane loads at once
  static constexpr int kChunk = 32 * kUK;   // a row's K a warp loads at once
  const Args& p;
  const Layout& L;
  int m0, warp, lane;
  bool staged;                           // init staged all of x
  float inv, epi;                        // 127 / sa, sa sb / 127^2
  int acc[2][NG][4];                     // [fragment][group][c]

  __device__ Op(const Args& p_, const Layout& L_) : p(p_), L(L_) {
    m0 = blockIdx.y * kR;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    zero();
  }

  __device__ void zero() {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[f][ng][c] = 0;
  }

  // x[m0 + warp + kWarps j][k0 + lane + 32 u] for this warp's rows j, 0
  // past M and K: every load of the chunk in flight at once (the table's
  // stream fills the memory system while x is staged)
  __device__ void load(float (&v)[kRW][kUK], int k0) const {
#pragma unroll
    for (int j = 0; j < kRW; ++j) {
      const int m = m0 + warp + kWarps * j;
#pragma unroll
      for (int u = 0; u < kUK; ++u) {
        const int k = k0 + lane + 32 * u;
        v[j][u] = m < p.M && k < p.t.K ? __ldg(p.x + m * p.ldx + k) : 0.f;
      }
    }
  }

  // a loaded chunk quantized at segment offset kl0, up to span
  __device__ void quantize(const float (&v)[kRW][kUK], int kl0, int span) {
    char* xs = L.ptr<char>(L.x);
#pragma unroll
    for (int j = 0; j < kRW; ++j)
#pragma unroll
      for (int u = 0; u < kUK; ++u) {
        const int kl = kl0 + lane + 32 * u;
        if (kl < span)
          xs[x_off<NG>(warp + kWarps * j, kl)] =
              static_cast<char>(quant(v[j][u], inv));
      }
  }

  // the scales' factors, read once a block (every thread loading them
  // would queue thousands of requests on one L2 line) beside x's first
  // loads; when all of x fits one chunk and one segment, it is staged
  // from those loads
  __device__ void init() {
    const int kp = (p.t.K + kStepK - 1) / kStepK * kStepK;
    staged = p.t.K <= kChunk && kp <= p.ks_seg;
    float* scales = L.ptr<float>(L.scratch);
    if (threadIdx.x == 0) {
      scales[0] = __ldg(p.sa);
      scales[1] = __ldg(p.sb);
    }
    float v[kRW][kUK];
    if (staged) load(v, 0);
    bar_consumers();
    const float sa = scales[0], sb = scales[1];
    inv = __fdiv_rn(127.0f, sa);
    epi = __fdiv_rn(sa * sb, 127.0f * 127.0f);
    if (staged) quantize(v, 0, kp);
  }

  __device__ void start(int) {}

  // K segment seg of this warp's x rows quantized, zero past M and K
  // (init staged them already when x fits at once)
  __device__ void stage(int seg) {
    if (staged) return;
    const int kp = (p.t.K + kStepK - 1) / kStepK * kStepK;
    const int k0 = seg * p.ks_seg, span = min(p.ks_seg, kp - k0);
    float v[kRW][kUK];
    for (int kl = 0; kl < span; kl += kChunk) {
      load(v, k0 + kl);
      quantize(v, kl, span);
    }
  }

  // k32 step j of the slot: a0 / a2 = words 2j / 2j + 1 of row g, a1 /
  // a3 of row g + 8; b0 / b1 the x words at the same K
  __device__ void step(const uint32_t (&a)[2][2][8], int kbl) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {          // x chunk i: k steps 2i, 2i + 1
      uint32_t b[NG][4];
#pragma unroll
      for (int ng = 0; ng < NG; ++ng)
        lds128(L.x + ((kbl * 2 + i) * NG + ng) * 512 + lane * 16, b[ng]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * i + jj;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const uint32_t fa[4] = {a[f][0][2 * j], a[f][1][2 * j],
                                  a[f][0][2 * j + 1], a[f][1][2 * j + 1]};
#pragma unroll
          for (int ng = 0; ng < NG; ++ng)
            mma_s8(acc[f][ng], fa, b[ng][2 * jj], b[ng][2 * jj + 1]);
        }
      }
    }
  }

  // c index 2 h + e of fragment f, group ng: table row 16 f + g + 8 h of
  // the warp's 32, x row 8 ng + 2 t + e
  __device__ void finish(int tile) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * kTileRows + 32 * warp + 16 * f + g + 8 * h;
        if (n >= p.t.N) continue;
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * ng + 2 * t4 + e;
            if (m0 + r < p.M)
              p.out[static_cast<long long>(m0 + r) * p.t.N + n] =
                  static_cast<float>(acc[f][ng][2 * h + e]) * epi;
          }
      }
    zero();
  }
};

template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_stream(const __grid_constant__ CUtensorMap map,
                const __grid_constant__ Args p) {
  extern __shared__ uint4 smem4[];
  const Layout L(smem4, kStages);
  Op<NG> op(p, L);
  run(&map, p.tma != 0, p.t, L, op, p.ks_seg);
}

template <int NG>
size_t smem_bytes(int ks_seg) {
  return fixed_bytes(kStages) + static_cast<size_t>(8 * NG) * ks_seg;
}

template <int NG>
int seg(int K) {
  return seg_k(K, 8 * NG, kXBudget);
}

template <int NG>
cudaError_t run_ng(Args args, int num_sms, cudaStream_t st) {
  CUtensorMap map = {};
  args.tma = table_map(&map, args.t);
  args.ks_seg = seg<NG>(args.t.K);
  return launch(w8a8_stream<NG>, map, args, args.t.N,
                (args.M + 8 * NG - 1) / (8 * NG), smem_bytes<NG>(args.ks_seg),
                num_sms, st);
}

}  // namespace w8a8

extern "C" int w8a8_matmul_f32_i8(const float* x, const int8_t* qb,
                                  const float* sa, const float* sb,
                                  float* out, int M, int N, int K,
                                  long long ldx, long long sk, long long sn,
                                  int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(M) * N, st));
  w8a8::Args args = {};
  args.t = tstream::Table{qb, sn, sk, N, K};
  args.x = x;
  args.ldx = ldx;
  args.M = M;
  args.sa = sa;
  args.sb = sb;
  args.out = out;
  const cudaError_t err = M <= 8 ? w8a8::run_ng<1>(args, num_sms, st)
                                 : w8a8::run_ng<2>(args, num_sms, st);
  return static_cast<int>(err);
}

// what w8a8_matmul_f32_i8 launches for M rows of x and depth K:
// registers and local (spilled) bytes a thread, threads and shared bytes
// a block, and the blocks an SM holds at once
extern "C" int w8a8_matmul_occupancy(int M, int K, int* out) {
  using namespace w8a8;
  if (M <= 8)
    return occupancy(w8a8_stream<1>, smem_bytes<1>(seg<1>(K)), out);
  return occupancy(w8a8_stream<2>, smem_bytes<2>(seg<2>(K)), out);
}

// ---------------------------------------------------------------------------
// B9, scaled_matmul for Hopper (sm_90a): the training path's quantized
// matmul, out[m, n] = f32(sum_k qa[m, k] * qb[k, n]) * (sa * sb / qmax^2)
// with
//   int8: q = clip(rint(x * (127 / s)), -127, 127), int32 accumulation,
//         qmax^2 = 16129;
//   fp8:  q = e4m3(clip(x * (448 / s), -448, 448)) (round to nearest
//         even), f32 accumulation, qmax^2 = 200704.
// a [M, K] f32, bf16 or f16 with a row stride, b a logical [K, N] f32,
// bf16 or f16 operand read through its element strides (a Linear weight [in, out],
// sn = 1, or the LM-head loss's transposed vocab chunk, sk = 1), sa and
// sb per-tensor f32 scales read from device memory (never on the host),
// out [M, N] f32 contiguous. 127 / s, 448 / s and the epilogue factor
// are IEEE divisions (__fdiv_rn; the build has no fast-math), rintf
// rounds half to even, and NaN maps to code 0 in int8 (XLA's float ->
// s8 convert) and stays NaN in fp8 (the clip propagates it).
//
// Replaces the Pallas TPU kernel `_qmm_kernel` of paddle_tpu/ops/lowp.py
// (reached through `_smm_pallas` -> `_pallas_mm`, public
// `scaled_matmul`): every routed Linear and every fused-loss score
// chunk of a FLAGS_lowp_matmul train step.
//
// Bound: at ERNIE's shapes (M = 16384 rows, K and N of 768 / 2304 / 3072,
// bf16 or f32 operands, f32 out) the 2 M N K int8 / fp8 operations take
// 0.4 to 0.5 of the time that reading the operands once and writing the
// f32 output take at 3.35 TB/s against 1979 TOP/s: the bytes (mostly
// the f32 output) bound it.
//
// Design: three launches on the caller's stream. Two quantise passes write the
// codes once: a -> qa [Mp, Kp] row-major, b -> qb [Np, Kp] K-major (wgmma
// reads 8-bit operands K-major only), zero past M, N and K up to the tile
// multiples (Mp, Np and Kp of 128: a zero code adds nothing, as the TPU
// kernel's zero padding). A K-major b is a straight row pass; an N-major one
// goes through a 32 x 32 shared-memory transpose so reads and writes both stay
// coalesced. Then the GEMM (qmm_wg): a block computes a 128 x 128 output tile
// with two consumer warpgroups of m64n128 warpgroup products, both operands
// read from 128-byte-swizzled shared memory, where a producer warp's TMA loads
// land in a ring of [128 rows][128 bytes of K] slots (mbarriers mark them full
// and empty), so the loads run ahead of the products; two blocks an SM, so one
// block's stores run under the other's products. int8 multiplies s8 x s8 ->
// s32 (k32 a product): int32 sums are exact (|acc| <= 127^2 K < 2^31 for K <
// 133143), so int8 is bitwise equal to the plain version. fp8 stores each e4m3
// code decoded to bf16 (exact) and multiplies bf16 x bf16 -> f32 (k16 a
// product): the products are exact and the f32 accumulation holds the plain
// version's tolerance. The e4m3 products themselves (wgmma .e4m3, k32)
// accumulate in the tensor cores with fewer mantissa bits: on an H100 they
// missed that tolerance at K of 100-200 by up to 3.6x with a fresh fragment
// every 64 of K added in f32, and by up to 1.24x with one every 32. The
// epilogue scales the tile into shared memory and writes it in 16-byte
// vectors, each warp one 512-byte output row at a time, M / N masked. On an
// H100 80GB HBM3 (700 W) a step's 69 calls take about 7.8 ms in int8 and 10.1
// ms in fp8 against 14.3 / 21.4 ms for the mma.sync design this replaced
// (chip_ab.py, one call), the quantise passes a quarter to a third of it
// (chip_smoke.py); the bound is 3.42 ms (bytes, mostly the f32 output). The
// GEMM's operand reads and output writes add up rather than overlap; neither a
// persistent grid whose TMA bulk stores drain under the next tile nor 256 x
// 128 tiles moved it.

namespace qmm {

using namespace sm90;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

// the stored code of x, inv = qmax / s: the int8 code, or the e4m3
// code decoded to bf16 (exact: bf16 holds every e4m3 value), the form
// the GEMM multiplies
template <bool kFp8>
__device__ __forceinline__ uint32_t code(float x, float inv) {
  float y = x * inv;
  if constexpr (kFp8) {
    y = y < -448.0f ? -448.0f : (y > 448.0f ? 448.0f : y);
    __nv_fp8_e4m3 q;
    q.__x = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    const __nv_bfloat16 v = __float2bfloat16_rn(static_cast<float>(q));
    return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&v));
  } else {
    y = rintf(y);
    y = y < -127.0f ? -127.0f : (y > 127.0f ? 127.0f : y);
    if (y != y) return 0u;
    return static_cast<uint32_t>(
        static_cast<uint8_t>(static_cast<int8_t>(y)));
  }
}

// dst [Rp, Cp] (Cp % 4 == 0): the code of src[r * rs + c * cs] inside
// [R, C], 0 outside; four codes a thread (one 32-bit word of int8
// codes, two of bf16)
template <typename T, bool kFp8>
__global__ void quant_rows(const T* __restrict__ src,
                           const float* __restrict__ s_ptr, float qmax,
                           void* __restrict__ dst, int R, int C, int Rp,
                           int Cp, long long rs, long long cs) {
  const float inv = __fdiv_rn(qmax, *s_ptr);
  const int quads = Cp / 4;
  const long long total = static_cast<long long>(Rp) * quads;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / quads);
    const int c = 4 * static_cast<int>(i % quads);
    uint32_t u[2] = {0u, 0u};
    if (r < R) {
      const T* p = src + r * rs;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < C) {
          const uint32_t q = code<kFp8>(to_f32(p[(c + j) * cs]), inv);
          if constexpr (kFp8)
            u[j >> 1] |= q << (16 * (j & 1));
          else
            u[0] |= q << (8 * j);
        }
    }
    if constexpr (kFp8)
      static_cast<uint2*>(dst)[i] = make_uint2(u[0], u[1]);
    else
      static_cast<uint32_t*>(dst)[i] = u[0];
  }
}

// dst [Np, Kp] K-major from the N-major logical [K, N] src (element
// strides sk, sn): 32 x 32 tiles through shared memory, block (32, 8)
template <typename T, bool kFp8>
__global__ void quant_cols(const T* __restrict__ src,
                           const float* __restrict__ s_ptr, float qmax,
                           void* __restrict__ dst_, int K, int N, int Kp,
                           long long sk, long long sn) {
  using Code = typename std::conditional<kFp8, uint16_t, uint8_t>::type;
  __shared__ Code tile[32][33];
  Code* dst = static_cast<Code*>(dst_);
  const float inv = __fdiv_rn(qmax, *s_ptr);
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < N)
                      ? static_cast<Code>(code<kFp8>(
                            to_f32(src[k * sk + n * sn]), inv))
                      : 0;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    dst[static_cast<long long>(n0 + i) * Kp + k0 + tx] = tile[tx][i];
}

// ---------------------------------------------------------------------------
// the GEMM: warpgroup products (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128;    // output tile of a block
constexpr int kRowBytes = 128;         // K step: one 128-byte swizzle row
constexpr int kConsumers = 256;        // two warpgroups, m64 each
constexpr int kThreads = kConsumers + 32;   // + the producer warp
constexpr uint32_t kSlab = 128 * kRowBytes;   // one operand's K step
constexpr int kStages = 3;
constexpr int kBlocks = 2;             // blocks an SM: one's stores run
                                       // under the other's products
constexpr size_t kRing = (size_t)kStages * 2 * kSlab;
constexpr size_t kSmem = 1024 + kRing + 2 * kStages * 8;
constexpr int kLdo = kBN + 8;          // staged output row stride (floats)
static_assert(kRing >= (size_t)kBM * kLdo * 4,
              "the staged output tile reuses the ring");

// d[64 x 128] (+)= A B over 32 bytes of K (32 int8 codes, or 16 bf16
// ones) from shared memory; lane (g, t) of warp w holds d[4 j + 2 h + e]
// = row 16 w + g + 8 h, column 8 j + 2 t + e
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// out [M, N] = (qa [Mp, Kp] x qb [Np, Kp]^T) * epilogue; grid (Np / 128,
// Mp / 128). A producer warp streams both operands' K steps through a
// ring of kStages slots ([128 rows][128 bytes] each, 128-byte swizzled,
// full / empty mbarriers); each consumer warpgroup multiplies its 64
// rows by the 128 columns, four products a step, and sums the whole of
// K in the tensor cores' accumulator: s32 for int8 (exact), f32 for the
// bf16-decoded e4m3 codes (their products are exact). The epilogue
// scales the tile into shared memory (the ring, free by then) and
// stores it in 512-byte rows of 16-byte vectors, M and N masked.
template <bool kFp8>
__global__ void __launch_bounds__(kThreads, kBlocks)
    qmm_wg(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb,
           const float* __restrict__ sa_ptr, const float* __restrict__ sb_ptr,
           float* __restrict__ out, int M, int N, int Kp) {
  using Acc = typename std::conditional<kFp8, float, int>::type;
  extern __shared__ uint4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t full = ring + (uint32_t)kRing;
  const uint32_t empty = full + 8 * kStages;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  constexpr int kStep = kFp8 ? kRowBytes / 2 : kRowBytes;   // K a step
  const int steps = Kp / kStep;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {            // the producer warp; one thread issues
    if (tid != kConsumers) return;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
      mbar_expect_tx(full + 8 * s, 2 * kSlab);
      const uint32_t dst = ring + s * 2 * kSlab;
      tma_load(dst, &ta, i * kStep, m0, full + 8 * s);
      tma_load(dst + kSlab, &tb, i * kStep, n0, full + 8 * s);
    }
    return;
  }

  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t a = ring + s * 2 * kSlab + wg * 64 * kRowBytes;
    const uint32_t b = ring + s * 2 * kSlab + kSlab;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg_desc(a + kk * 32, 16, 1024);
      const uint64_t db = wg_desc(b + kk * 32, 16, 1024);
      if constexpr (kFp8)
        wgmma_bf16(acc, da, db, 1);
      else
        wgmma_s8(acc, da, db, 1);
    }
    wg_commit();
    wg_wait<1>();           // step i - 1 is done: release its slot
    if (i > 0) mbar_arrive(empty + 8 * ((i - 1) % kStages));
  }
  wg_wait<0>();
  reg_fence(acc);

  // the scaled tile through shared memory (every product has read its
  // operands once both warpgroups pass the barrier), then rows out
  const float epi = __fdiv_rn(*sa_ptr * *sb_ptr,
                              kFp8 ? 448.0f * 448.0f : 127.0f * 127.0f);
  float* stage = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + (ring - raw));
  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + g + 8 * h;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<float2*>(stage + r * kLdo + 8 * j + 2 * t4) =
          make_float2(static_cast<float>(acc[4 * j + 2 * h]) * epi,
                      static_cast<float>(acc[4 * j + 2 * h + 1]) * epi);
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  const int n = n0 + 4 * lane;
  const bool vec = N % 4 == 0;
  for (int row = tid >> 5; row < kBM && m0 + row < M; row += kConsumers / 32) {
    const float* src = stage + row * kLdo + 4 * lane;
    float* dst = out + static_cast<long long>(m0 + row) * N + n;
    if (vec) {
      if (n < N) *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) dst[e] = src[e];
    }
  }
}

// codes [rows, Kp] (Kp a multiple of 128; int8, or bf16 for fp8) read
// in boxes of [128 rows][128 bytes], 128-byte swizzled
bool code_map(CUtensorMap* map, const void* base, int rows, int Kp,
              bool fp8) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp * (fp8 ? 2 : 1)};
  const cuuint32_t box[2] = {(cuuint32_t)(fp8 ? 64 : 128), 128};
  const cuuint32_t step[2] = {1, 1};
  return enc(map,
             fp8 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kFp8>
cudaError_t quant_a(const void* a, long long lda, const float* sa,
                    void* qa, int M, int K, int Mp, int Kp, int num_sms,
                    cudaStream_t st) {
  const long long words = static_cast<long long>(Mp) * (Kp / 4);
  const int blocks = static_cast<int>(
      std::min<long long>((words + 255) / 256, num_sms * 8LL));
  quant_rows<T, kFp8><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(a), sa, kFp8 ? 448.0f : 127.0f, qa, M, K, Mp,
      Kp, lda, 1);
  return cudaGetLastError();
}

template <typename T, bool kFp8>
cudaError_t quant_b(const void* b, long long sk, long long sn,
                    const float* sb, void* qb, int K, int N, int Np,
                    int Kp, int num_sms, cudaStream_t st) {
  const float qmax = kFp8 ? 448.0f : 127.0f;
  if (sk == 1) {                        // K-major already: rows of qb
    const long long words = static_cast<long long>(Np) * (Kp / 4);
    const int blocks = static_cast<int>(
        std::min<long long>((words + 255) / 256, num_sms * 8LL));
    quant_rows<T, kFp8><<<blocks, 256, 0, st>>>(
        static_cast<const T*>(b), sb, qmax, qb, N, K, Np, Kp, sn, 1);
  } else {
    const dim3 grid(Np / 32, Kp / 32);
    quant_cols<T, kFp8><<<grid, dim3(32, 8), 0, st>>>(
        static_cast<const T*>(b), sb, qmax, qb, K, N, Kp, sk, sn);
  }
  return cudaGetLastError();
}

// a_dtype / b_dtype: 0 f32, 1 bf16, 2 f16 (each operand is quantised
// from its own dtype)
template <bool kFp8>
cudaError_t run(const void* a, int a_dtype, long long lda, const void* b,
                int b_dtype, long long sk, long long sn, const float* sa,
                const float* sb, void* qa, void* qb, float* out, int M,
                int N, int K, int Mp, int Np, int Kp, int num_sms,
                cudaStream_t st) {
  if (a_dtype < 0 || a_dtype > 2 || b_dtype < 0 || b_dtype > 2)
    return cudaErrorInvalidValue;
  cudaError_t err =
      a_dtype == 1
          ? quant_a<__nv_bfloat16, kFp8>(a, lda, sa, qa, M, K, Mp, Kp,
                                         num_sms, st)
      : a_dtype == 2
          ? quant_a<__half, kFp8>(a, lda, sa, qa, M, K, Mp, Kp, num_sms, st)
          : quant_a<float, kFp8>(a, lda, sa, qa, M, K, Mp, Kp, num_sms, st);
  if (err != cudaSuccess) return err;
  err = b_dtype == 1
            ? quant_b<__nv_bfloat16, kFp8>(b, sk, sn, sb, qb, K, N, Np, Kp,
                                           num_sms, st)
        : b_dtype == 2
            ? quant_b<__half, kFp8>(b, sk, sn, sb, qb, K, N, Np, Kp, num_sms,
                                    st)
            : quant_b<float, kFp8>(b, sk, sn, sb, qb, K, N, Np, Kp, num_sms,
                                   st);
  if (err != cudaSuccess) return err;
  CUtensorMap ta, tb;
  if (!code_map(&ta, qa, Mp, Kp, kFp8) || !code_map(&tb, qb, Np, Kp, kFp8))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(qmm_wg<kFp8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return err;
  qmm_wg<kFp8><<<dim3(Np / kBN, Mp / kBM), kThreads, kSmem, st>>>(
      ta, tb, sa, sb, out, M, N, Kp);
  return cudaGetLastError();
}

}  // namespace qmm

// B9: the scratch qa [Mp, Kp] and qb [Np, Kp] (int8 codes, or for fp8
// bf16 ones: 2 Kp bytes a row; 16-byte aligned) and out [M, N] f32 are
// the caller's; Mp, Np and Kp are multiples of 128, all > 0
extern "C" int scaled_matmul_q(const void* a, int a_dtype, long long lda,
                               const void* b, int b_dtype, long long sk,
                               long long sn, const float* sa,
                               const float* sb, void* qa, void* qb,
                               float* out, int M, int N, int K, int Mp,
                               int Np, int Kp, int fp8, int num_sms,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      fp8 ? qmm::run<true>(a, a_dtype, lda, b, b_dtype, sk, sn, sa, sb, qa,
                           qb, out, M, N, K, Mp, Np, Kp, num_sms, st)
          : qmm::run<false>(a, a_dtype, lda, b, b_dtype, sk, sn, sa, sb, qa,
                            qb, out, M, N, K, Mp, Np, Kp, num_sms, st);
  return static_cast<int>(err);
}

// what scaled_matmul_q's GEMM launches in int8 (fp8 0) or fp8: registers
// and local (spilled) bytes a thread, threads and shared bytes a block,
// and the blocks an SM holds at once
extern "C" int scaled_matmul_occupancy(int fp8, int* out) {
  const void* fn = fp8 ? reinterpret_cast<const void*>(qmm::qmm_wg<true>)
                       : reinterpret_cast<const void*>(qmm::qmm_wg<false>);
  const int bytes = static_cast<int>(qmm::kSmem);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], fn, qmm::kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = qmm::kThreads;
  out[3] = bytes;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
