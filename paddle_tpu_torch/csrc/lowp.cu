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

#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
