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
// Design: a persistent grid (kBlocksPerSM blocks per SM) walks the
// table in tiles of kRowsPerBlock columns n. The block quantizes its
// 8-row x tile into shared memory once (once per K tile when K exceeds
// it): rintf = round half to even, like jnp.round; IEEE division
// 127/sa, no fast-math. Each warp owns kRows columns of a tile and its
// lanes split K, 16 bytes per lane per step (one int4 load of the
// table, one of the quantized x row), accumulating with __dp4a in
// int32; the loads of the warp's next step are issued before the
// current step's arithmetic. A shuffle reduce-scatter leaves each lane
// at most two finished outputs. The int32 sums are exact, so the result
// is bitwise equal to the plain version. With sk != 1 (a K-major table)
// the kernel falls back to byte loads. Ragged M, N and K edges are
// masked, never padded.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 256;                       // 8 warps
constexpr int kBlocksPerSM = 2;
constexpr int kRows = 4;                            // table columns per warp
constexpr int kRowsPerBlock = (kThreads / 32) * kRows;
constexpr int kMTile = 8;                           // x rows per block
constexpr int kKTile = 2048;                        // K staged per pass
constexpr int kLaneK = 16;                          // int8 per lane per step
constexpr int kWarpK = 32 * kLaneK;                 // K per warp step
constexpr int kAcc = kMTile * kRows;                // sums per warp

__device__ __forceinline__ int word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one step of a warp reduce-scatter over v[0 : 2*HALF]: lanes keep the
// half selected by their bit HALF/2, adding the partner's copy
template <int HALF, typename T>
__device__ __forceinline__ void rs_step(T* v, int lane) {
  const bool upper = lane & (HALF / 2);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF / 2);
  }
}

// v[0 : kAcc] summed over the warp: lane l ends with the totals of
// indices 2l and 2l + 1 in v[0] and v[1] (lanes with 2l >= kAcc hold
// copies and write nothing)
template <typename T>
__device__ __forceinline__ void reduce_scatter(T* v, int lane) {
  static_assert(kAcc == 32 || kAcc == 64, "kAcc must be 32 or 64");
  if constexpr (kAcc == 64) rs_step<32>(v, lane);
  rs_step<16>(v, lane);
  rs_step<8>(v, lane);
  rs_step<4>(v, lane);
  rs_step<2>(v, lane);
  if constexpr (kAcc == 32) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);
    v[1] += __shfl_xor_sync(0xffffffffu, v[1], 16);
  }
}

__device__ __forceinline__ unsigned quant(float v, float inv) {
  v = fminf(fmaxf(rintf(v * inv), -127.0f), 127.0f);
  return static_cast<unsigned char>(static_cast<int8_t>(v));
}

// quantized x[m0 : m0+8, k0 : k0+kt] -> xq, zero past M and past kt up
// to the next multiple of kWarpK (the compute loop reads no further)
__device__ __forceinline__ void stage_x(int8_t (*xq)[kKTile],
                                        const float* __restrict__ x,
                                        int M, int m0, int k0, int kt,
                                        long long ldx, float inv) {
  const int groups = ((kt + kWarpK - 1) / kWarpK) * kWarpK / 4;
  for (int i = threadIdx.x; i < kMTile * groups; i += kThreads) {
    const int m = i / groups, k = 4 * (i % groups);
    unsigned u = 0;
    if (m0 + m < M) {
      const float* src = x + static_cast<long long>(m0 + m) * ldx + k0 + k;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + b < kt) u |= quant(src[b], inv) << (8 * b);
    }
    *reinterpret_cast<unsigned*>(&xq[m][k]) = u;
  }
}

// the warp's 16 table bytes at k0 + kk of each of its columns (zeros
// past N and past kt)
template <bool kVec>
__device__ __forceinline__ void load_cols(int4 (&wv)[kRows],
                                          const int8_t* __restrict__ qb,
                                          int N, int n0, int k0, int kk,
                                          int kt, long long sk,
                                          long long sn) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    wv[r] = make_int4(0, 0, 0, 0);
    if (n < N && kk < kt) {
      const int8_t* p = qb + static_cast<long long>(n) * sn +
                        static_cast<long long>(k0 + kk) * sk;
      if (kVec) {
        wv[r] = __ldg(reinterpret_cast<const int4*>(p));
      } else {
        int w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          unsigned u = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = kk + 4 * t + b;
            const unsigned v =
                k < kt ? static_cast<unsigned char>(p[(4 * t + b) * sk])
                       : 0u;
            u |= v << (8 * b);
          }
          w[t] = static_cast<int>(u);
        }
        wv[r] = make_int4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
w8a8_matmul_kernel(const float* __restrict__ x,
                   const int8_t* __restrict__ qb,
                   const float* __restrict__ sa_ptr,
                   const float* __restrict__ sb_ptr,
                   float* __restrict__ out, int M, int N, int K,
                   long long ldx, long long sk, long long sn) {
  __shared__ __align__(16) int8_t xq[kMTile][kKTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const float sa = *sa_ptr;
  const float sb = *sb_ptr;
  const float inv = 127.0f / sa;
  const float epi = sa * sb / (127.0f * 127.0f);
  const bool once = K <= kKTile;
  if (once) {
    stage_x(xq, x, M, m0, 0, K, ldx, inv);
    __syncthreads();
  }
  // the warp walks items (tile nb, K tile k0, step j) in order; the
  // loads of item i + 1 are in flight while item i computes
  int nb = blockIdx.x * kRowsPerBlock;
  if (nb >= N) return;
  int k0 = 0, j = 0;
  int4 cur[kRows];
  load_cols<kVec>(cur, qb, N, nb + warp * kRows, 0, lane * kLaneK,
                  min(kKTile, K), sk, sn);
  int acc[kAcc];                       // acc[m * kRows + r]
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0;

  while (true) {
    const int kt = min(kKTile, K - k0);
    int nnb = nb, nk0 = k0, nj = j + 1;
    if (nj * kWarpK >= kt) {
      nj = 0;
      nk0 = k0 + kKTile;
      if (nk0 >= K) {
        nk0 = 0;
        nnb = nb + gridDim.x * kRowsPerBlock;
      }
    }
    const bool more = nnb < N;
    int4 nxt[kRows];
    if (more)
      load_cols<kVec>(nxt, qb, N, nnb + warp * kRows, nk0,
                      lane * kLaneK + nj * kWarpK, min(kKTile, K - nk0),
                      sk, sn);
    if (!once && j == 0) {
      __syncthreads();
      stage_x(xq, x, M, m0, k0, kt, ldx, inv);
      __syncthreads();
    }
    const int kk = lane * kLaneK + j * kWarpK;
    if (kk < kt) {
#pragma unroll
      for (int m = 0; m < kMTile; ++m) {
        const int4 xv = *reinterpret_cast<const int4*>(&xq[m][kk]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int a = word(xv, t);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[m * kRows + r] =
                __dp4a(a, word(cur[r], t), acc[m * kRows + r]);
        }
      }
    }
    if (nnb != nb) {                   // the tile's last item: finish it
      reduce_scatter(acc, lane);
      const int n0 = nb + warp * kRows;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int idx = 2 * lane + jj;
        const int m = m0 + idx / kRows, n = n0 + idx % kRows;
        if (idx < kAcc && m < M && n < N)
          out[static_cast<long long>(m) * N + n] =
              static_cast<float>(acc[jj]) * epi;
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    }
    if (!more) break;
    nb = nnb;
    k0 = nk0;
    j = nj;
#pragma unroll
    for (int r = 0; r < kRows; ++r) cur[r] = nxt[r];
  }
}

}  // namespace

extern "C" int w8a8_matmul_f32_i8(const float* x, const int8_t* qb,
                                  const float* sa, const float* sb,
                                  float* out, int M, int N, int K,
                                  long long ldx, long long sk, long long sn,
                                  int num_sms, void* stream) {
  const int tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(min(tiles, num_sms * kBlocksPerSM),
                  (M + kMTile - 1) / kMTile);
  const bool vec = sk == 1 && K % kLaneK == 0 && sn % kLaneK == 0 &&
                   reinterpret_cast<uintptr_t>(qb) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    w8a8_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        x, qb, sa, sb, out, M, N, K, ldx, sk, sn);
  } else {
    w8a8_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        x, qb, sa, sb, out, M, N, K, ldx, sk, sn);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B9, scaled_matmul for Hopper (sm_90a): the training path's quantized
// matmul, out[m, n] = f32(sum_k qa[m, k] * qb[k, n]) * (sa * sb / qmax^2)
// with
//   int8: q = clip(rint(x * (127 / s)), -127, 127), int32 accumulation,
//         qmax^2 = 16129;
//   fp8:  q = e4m3(clip(x * (448 / s), -448, 448)) (round to nearest
//         even), f32 accumulation, qmax^2 = 200704.
// a [M, K] f32 or bf16 with a row stride, b a logical [K, N] f32 or bf16
// operand read through its element strides (a Linear weight [in, out],
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
// Design: three launches on the caller's stream. Two quantise passes
// write the codes once: a -> qa [Mp, Kp] row-major, b -> qb [Np, Kp]
// K-major (the "col" operand of mma), zero past M, N and K up to the
// tile multiples (Mp, Np of 128, Kp of 64: a zero code adds nothing, as
// the TPU kernel's zero padding). A K-major b is a straight row pass; an
// N-major one goes through a 32 x 32 shared-memory transpose so reads
// and writes both stay coalesced. Then a tiled GEMM: a block computes a
// 128 x 128 output tile with 8 warps of 64 x 32, K in steps of 64 bytes
// through a 3-stage cp.async ring (rows padded to 80 bytes: the
// fragments' 32-bit loads fall on 32 distinct banks), on
// mma.sync.m16n8k32 (s8 x s8 -> s32, or e4m3 x e4m3 -> f32). int32 sums
// are exact (|acc| <= 127^2 K < 2^31 for K < 133143), so int8 is bitwise
// equal to the plain version. fp8: the tensor cores' f32 accumulation
// keeps fewer mantissa bits than an f32 add, so each 64-deep K step
// starts a fresh fragment that is added into f32 registers on the CUDA
// cores. The epilogue scales and stores with M / N masked.

namespace qmm {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kLds = kBK + 16;                   // smem row bytes
constexpr int kThreads = 256;                    // 8 warps, 2 (M) x 4 (N)
constexpr int kStageBytes = (kBM + kBN) * kLds;
constexpr int kSmem = kStages * kStageBytes;     // 61440 bytes

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the code of x, inv = qmax / s
template <bool kFp8>
__device__ __forceinline__ uint32_t code(float x, float inv) {
  float y = x * inv;
  if constexpr (kFp8) {
    y = y < -448.0f ? -448.0f : (y > 448.0f ? 448.0f : y);
    return static_cast<uint32_t>(
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
  } else {
    y = rintf(y);
    y = y < -127.0f ? -127.0f : (y > 127.0f ? 127.0f : y);
    if (y != y) return 0u;
    return static_cast<uint32_t>(
        static_cast<uint8_t>(static_cast<int8_t>(y)));
  }
}

// dst [Rp, Cp] (Cp % 4 == 0): the code of src[r * rs + c * cs] inside
// [R, C], 0 outside; four codes (one 32-bit word) a thread
template <typename T, bool kFp8>
__global__ void quant_rows(const T* __restrict__ src,
                           const float* __restrict__ s_ptr, float qmax,
                           uint32_t* __restrict__ dst, int R, int C,
                           int Rp, int Cp, long long rs, long long cs) {
  const float inv = __fdiv_rn(qmax, *s_ptr);
  const int words = Cp / 4;
  const long long total = static_cast<long long>(Rp) * words;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / words);
    const int c = 4 * static_cast<int>(i % words);
    uint32_t u = 0;
    if (r < R) {
      const T* p = src + r * rs;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < C)
          u |= code<kFp8>(to_f32(p[(c + j) * cs]), inv) << (8 * j);
    }
    dst[i] = u;
  }
}

// dst [Np, Kp] K-major from the N-major logical [K, N] src (element
// strides sk, sn): 32 x 32 tiles through shared memory, block (32, 8)
template <typename T, bool kFp8>
__global__ void quant_cols(const T* __restrict__ src,
                           const float* __restrict__ s_ptr, float qmax,
                           uint8_t* __restrict__ dst, int K, int N, int Kp,
                           long long sk, long long sn) {
  __shared__ uint8_t tile[32][33];
  const float inv = __fdiv_rn(qmax, *s_ptr);
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < K && n < N)
                      ? static_cast<uint8_t>(code<kFp8>(
                            to_f32(src[k * sk + n * sn]), inv))
                      : 0;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    dst[static_cast<long long>(n0 + i) * Kp + k0 + tx] = tile[tx][i];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_e4m3(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// out [M, N] = (qa [Mp, Kp] x qb [Np, Kp]^T) * epilogue; grid (Np / 128,
// Mp / 128)
template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
qmm_gemm(const uint8_t* __restrict__ qa, const uint8_t* __restrict__ qb,
         const float* __restrict__ sa_ptr, const float* __restrict__ sb_ptr,
         float* __restrict__ out, int M, int N, int Kp) {
  extern __shared__ __align__(16) uint8_t smem[];
  using Acc = typename std::conditional<kFp8, float, int>::type;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt_n = Kp / kBK;
  const uint8_t* ga = qa + static_cast<long long>(m0) * Kp;
  const uint8_t* gb = qb + static_cast<long long>(n0) * Kp;

  auto load = [&](int kt) {
    uint8_t* sa_ = smem + (kt % kStages) * kStageBytes;
    uint8_t* sb_ = sa_ + kBM * kLds;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;        // 512 16-byte chunks each
      const int row = c >> 2, col = (c & 3) * 16;
      const long long off = static_cast<long long>(row) * Kp + kt * kBK + col;
      cp_async16(sa_ + row * kLds + col, ga + off);
      cp_async16(sb_ + row * kLds + col, gb + off);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < kt_n) load(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* As = smem + (kt % kStages) * kStageBytes;
    const uint8_t* Bs = As + kBM * kLds;
    uint32_t af[2][4][4], bf[2][4][2];       // both 32-deep halves
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* p = As + (wm + mi * 16 + g) * kLds + 32 * h + 4 * t;
        af[h][mi][0] = ld32(p);
        af[h][mi][1] = ld32(p + 8 * kLds);
        af[h][mi][2] = ld32(p + 16);
        af[h][mi][3] = ld32(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = Bs + (wn + ni * 8 + g) * kLds + 32 * h + 4 * t;
        bf[h][ni][0] = ld32(p);
        bf[h][ni][1] = ld32(p + 16);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if constexpr (kFp8) {
          // a fresh fragment for this 64-deep step, added in f32 here
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_e4m3(part, af[0][mi], bf[0][ni]);
          mma_e4m3(part, af[1][mi], bf[1][ni]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][ni][j] += part[j];
        } else {
          mma_s8(acc[mi][ni], af[0][mi], bf[0][ni]);
          mma_s8(acc[mi][ni], af[1][mi], bf[1][ni]);
        }
      }
  }

  const float epi = __fdiv_rn(*sa_ptr * *sb_ptr,
                              kFp8 ? 448.0f * 448.0f : 127.0f * 127.0f);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m0 + wm + mi * 16 + g + (j >> 1) * 8;
        const int c = n0 + wn + ni * 8 + 2 * t + (j & 1);
        if (r < M && c < N)
          out[static_cast<long long>(r) * N + c] =
              static_cast<float>(acc[mi][ni][j]) * epi;
      }
}

template <typename T, bool kFp8>
cudaError_t quant_a(const void* a, long long lda, const float* sa,
                    uint8_t* qa, int M, int K, int Mp, int Kp, int num_sms,
                    cudaStream_t st) {
  const long long words = static_cast<long long>(Mp) * (Kp / 4);
  const int blocks = static_cast<int>(
      std::min<long long>((words + 255) / 256, num_sms * 8LL));
  quant_rows<T, kFp8><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(a), sa, kFp8 ? 448.0f : 127.0f,
      reinterpret_cast<uint32_t*>(qa), M, K, Mp, Kp, lda, 1);
  return cudaGetLastError();
}

template <typename T, bool kFp8>
cudaError_t quant_b(const void* b, long long sk, long long sn,
                    const float* sb, uint8_t* qb, int K, int N, int Np,
                    int Kp, int num_sms, cudaStream_t st) {
  const float qmax = kFp8 ? 448.0f : 127.0f;
  if (sk == 1) {                        // K-major already: rows of qb
    const long long words = static_cast<long long>(Np) * (Kp / 4);
    const int blocks = static_cast<int>(
        std::min<long long>((words + 255) / 256, num_sms * 8LL));
    quant_rows<T, kFp8><<<blocks, 256, 0, st>>>(
        static_cast<const T*>(b), sb, qmax, reinterpret_cast<uint32_t*>(qb),
        N, K, Np, Kp, sn, 1);
  } else {
    const dim3 grid(Np / 32, Kp / 32);
    quant_cols<T, kFp8><<<grid, dim3(32, 8), 0, st>>>(
        static_cast<const T*>(b), sb, qmax, qb, K, N, Kp, sk, sn);
  }
  return cudaGetLastError();
}

template <bool kFp8>
cudaError_t run(const void* a, int a_bf16, long long lda, const void* b,
                int b_bf16, long long sk, long long sn, const float* sa,
                const float* sb, uint8_t* qa, uint8_t* qb, float* out, int M,
                int N, int K, int Mp, int Np, int Kp, int num_sms,
                cudaStream_t st) {
  cudaError_t err = a_bf16
      ? quant_a<__nv_bfloat16, kFp8>(a, lda, sa, qa, M, K, Mp, Kp, num_sms,
                                     st)
      : quant_a<float, kFp8>(a, lda, sa, qa, M, K, Mp, Kp, num_sms, st);
  if (err != cudaSuccess) return err;
  err = b_bf16
      ? quant_b<__nv_bfloat16, kFp8>(b, sk, sn, sb, qb, K, N, Np, Kp,
                                     num_sms, st)
      : quant_b<float, kFp8>(b, sk, sn, sb, qb, K, N, Np, Kp, num_sms, st);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(qmm_gemm<kFp8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return err;
  qmm_gemm<kFp8><<<dim3(Np / kBN, Mp / kBM), kThreads, kSmem, st>>>(
      qa, qb, sa, sb, out, M, N, Kp);
  return cudaGetLastError();
}

}  // namespace qmm

// B9: the scratch qa [Mp, Kp] and qb [Np, Kp] (bytes) and out [M, N] f32
// are the caller's; Mp, Np are multiples of 128 and Kp of 64, all > 0
extern "C" int scaled_matmul_q(const void* a, int a_bf16, long long lda,
                               const void* b, int b_bf16, long long sk,
                               long long sn, const float* sa,
                               const float* sb, uint8_t* qa, uint8_t* qb,
                               float* out, int M, int N, int K, int Mp,
                               int Np, int Kp, int fp8, int num_sms,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      fp8 ? qmm::run<true>(a, a_bf16, lda, b, b_bf16, sk, sn, sa, sb, qa,
                           qb, out, M, N, K, Mp, Np, Kp, num_sms, st)
          : qmm::run<false>(a, a_bf16, lda, b, b_bf16, sk, sn, sa, sb, qa,
                            qb, out, M, N, K, Mp, Np, Kp, num_sms, st);
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
