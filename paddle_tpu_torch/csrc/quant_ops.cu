// dequant_matmul for Hopper (sm_90a):
//   out[m, n] = (sum_k x[m, k] * float(q[n, k])) * (scale[n] / 127)
// x [M, K] f32 (row stride ldx), q [N, K] int8 (row stride ldq, K
// contiguous), scale one f32 per row or one for all (scale_stride 0),
// out [M, N] f32 contiguous.
//
// Replaces the Pallas TPU kernel `_dq_kernel` of
// paddle_tpu/ops/quant_ops.py (reached through `_dq_mm_pallas`, public
// `dequant_matmul`): the serving engine's int8 tied LM head, where M is
// a handful of decode rows and q is the whole [vocab, hidden] table.
//
// Bound: device-memory bytes. At M = 8, K = 768, N = 50304 the table is
// 38.6 MB read once and does 2*M flops per byte, below the card's ~20
// f32 flops per byte, so the kernel is a GEMV-like stream of the table.
// Design: a persistent grid (kBlocksPerSM blocks per SM) walks the
// table in tiles of kRowsPerBlock rows; each warp owns kRows rows of a
// tile and its lanes split K, 16 bytes (one int4 load) per lane per
// step. The loads of a warp's next step (next K slice or next tile) are
// issued before the current step's arithmetic, so every warp keeps its
// next 16 bytes per row in flight while it computes. The block stages
// its 8-row tile of x in shared memory once (once per K tile when K
// exceeds it), swizzled so that a warp's float4 reads are free of bank
// conflicts, and each x value read there is reused across the warp's
// rows. Each table byte is converted to f32 once (a byte permute into a
// float's mantissa and one subtraction — the int-to-float unit is a
// sixteenth as fast) and feeds the 8 x rows' FMAs. No padding copies:
// ragged M, N and K edges are masked in the kernel. A shuffle
// reduce-scatter leaves each lane at most two finished outputs, and the
// epilogue applies scale[n] / 127 as the reference does (IEEE division;
// built without fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                       // 8 warps
constexpr int kBlocksPerSM = 2;
constexpr int kRows = 4;                            // table rows per warp
constexpr int kRowsPerBlock = (kThreads / 32) * kRows;
constexpr int kMTile = 8;                           // x rows per block
constexpr int kKTile = 1024;                        // K staged per pass
constexpr int kLaneK = 16;                          // int8 per lane per step
constexpr int kWarpK = 32 * kLaneK;                 // K per warp step
constexpr int kAcc = kMTile * kRows;                // sums per warp

// signed byte b of w as f32, given wf = w ^ 0x80808080 (each byte
// biased to b + 128): 0x4B0000uu is the float 2^23 + uu, exactly
__device__ __forceinline__ float sbyte(int wf, int b) {
  return __int_as_float(__byte_perm(wf, 0x4B000000, 0x7540 + b)) -
         8388736.0f;
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

// shared-memory position of x[., k]: a lane's 16 consecutive k live in
// four float4s, laid out so that the 32 lanes of a warp read 32
// consecutive float4s (no bank conflicts) for each of the four
__device__ __forceinline__ int swz(int k) {
  return (k & ~511) | (((k >> 2) & 3) << 7) | (((k >> 4) & 31) << 2) |
         (k & 3);
}

__device__ __forceinline__ int word(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// x[m0 : m0+8, k0 : k0+kt] -> xs, zero past M and past kt up to the
// next multiple of kWarpK (the compute loop reads no further)
__device__ __forceinline__ void stage_x(float (*xs)[kKTile],
                                        const float* __restrict__ x,
                                        int M, int m0, int k0, int kt,
                                        long long ldx) {
  const int groups = ((kt + kWarpK - 1) / kWarpK) * kWarpK / 4;
  for (int i = threadIdx.x; i < kMTile * groups; i += kThreads) {
    const int m = i / groups, k = 4 * (i % groups);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + m < M) {
      const float* src = x + static_cast<long long>(m0 + m) * ldx + k0 + k;
      if (k + 0 < kt) v.x = src[0];
      if (k + 1 < kt) v.y = src[1];
      if (k + 2 < kt) v.z = src[2];
      if (k + 3 < kt) v.w = src[3];
    }
    *reinterpret_cast<float4*>(&xs[m][swz(k)]) = v;
  }
}

// the warp's 16 table bytes at k0 + kk of each of its rows (zeros past
// N and past kt)
template <bool kVec>
__device__ __forceinline__ void load_rows(int4 (&wv)[kRows],
                                          const int8_t* __restrict__ q,
                                          int N, int n0, int k0, int kk,
                                          int kt, long long ldq) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    wv[r] = make_int4(0, 0, 0, 0);
    if (n < N && kk < kt) {
      const int8_t* p = q + static_cast<long long>(n) * ldq + k0 + kk;
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
                k < kt ? static_cast<unsigned char>(p[4 * t + b]) : 0u;
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
dequant_matmul_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ q,
                      const float* __restrict__ scale,
                      float* __restrict__ out, int M, int N, int K,
                      long long ldx, long long ldq, int scale_stride) {
  __shared__ __align__(16) float xs[kMTile][kKTile];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kMTile;
  const bool once = K <= kKTile;
  if (once) {
    stage_x(xs, x, M, m0, 0, K, ldx);
    __syncthreads();
  }
  // the warp walks items (tile nb, K tile k0, step j) in order; the
  // loads of item i + 1 are in flight while item i computes
  int nb = blockIdx.x * kRowsPerBlock;
  if (nb >= N) return;
  int k0 = 0, j = 0;
  int4 cur[kRows];
  load_rows<kVec>(cur, q, N, nb + warp * kRows, 0, lane * kLaneK,
                  min(kKTile, K), ldq);
  float acc[kAcc];                     // acc[m * kRows + r]
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

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
      load_rows<kVec>(nxt, q, N, nnb + warp * kRows, nk0,
                      lane * kLaneK + nj * kWarpK, min(kKTile, K - nk0),
                      ldq);
    if (!once && j == 0) {
      __syncthreads();
      stage_x(xs, x, M, m0, k0, kt, ldx);
      __syncthreads();
    }
    const int kk = lane * kLaneK + j * kWarpK;
    if (kk < kt) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float wf[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int w = word(cur[r], t) ^ 0x80808080;
#pragma unroll
          for (int b = 0; b < 4; ++b) wf[r][b] = sbyte(w, b);
        }
#pragma unroll
        for (int m = 0; m < kMTile; ++m) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &xs[m][(kk & ~511) | (t << 7) | (lane << 2)]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float& a = acc[m * kRows + r];
            a = fmaf(xv.x, wf[r][0], a);
            a = fmaf(xv.y, wf[r][1], a);
            a = fmaf(xv.z, wf[r][2], a);
            a = fmaf(xv.w, wf[r][3], a);
          }
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
        if (idx < kAcc && m < M && n < N) {
          const float s = scale[static_cast<long long>(n) * scale_stride];
          out[static_cast<long long>(m) * N + n] = acc[jj] * (s / 127.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
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

extern "C" int dequant_matmul_f32_i8(const float* x, const int8_t* q,
                                     const float* scale, float* out, int M,
                                     int N, int K, long long ldx,
                                     long long ldq, int scale_stride,
                                     int num_sms, void* stream) {
  const int tiles = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(min(tiles, num_sms * kBlocksPerSM),
                  (M + kMTile - 1) / kMTile);
  const bool vec = K % kLaneK == 0 && ldq % kLaneK == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    dequant_matmul_kernel<true><<<grid, kThreads, 0, st>>>(
        x, q, scale, out, M, N, K, ldx, ldq, scale_stride);
  } else {
    dequant_matmul_kernel<false><<<grid, kThreads, 0, st>>>(
        x, q, scale, out, M, N, K, ldx, ldq, scale_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
