// Flash attention forward and backward for Hopper (sm_90a), on
// [b, h, s, d] tensors addressed through (batch, head, row) element
// strides with a contiguous last dim, in f32 or bf16, head dim 32, 64
// or 128, any sq and sk (ragged against the 64-row tiles), causal mask
// aligned bottom-right (query i sees keys <= i + sk - sq), in-kernel
// attention dropout.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/fused_ops.py:
//   B1 `_fwd_kernel`      -> fwd_kernel: o and lse = m + log(l)
//   B2 `_bwd_dq_kernel`   -> dq_kernel:  dq = scale * sum_k ds * k
//   B3 `_bwd_dkv_kernel`  -> dkv_kernel: dv = pd^T do, dk = scale * ds^T q
// with p recomputed from lse, ds = p * (dp * keep/(1-p) - delta), delta
// = rowsum(do * o) computed by the wrapper.
//
// Bound: at the ERNIE shape (b*h = 384, s = 512, d = 64, bf16) the work
// is 26-52 GFLOP per call against ~100-150 MB of operands: operations,
// not bytes. These first kernels compute on the CUDA cores in f32 (bf16
// operands are converted once on their way into shared memory), so f32
// stays full f32 (no TF32) and both dtypes share one code path. Design:
// one block of 256 threads per (64-row tile, b*h); the tile's resident
// operands sit in shared memory as f32, the streamed ones are staged one
// 64-row tile at a time; each thread owns a 4x4 block of the 64x64 score
// tile (row group = tid / 16, column group = tid % 16) and 4 rows x d/16
// columns of the output tile, so every inner step is two 16-byte
// shared-memory loads feeding 16 FMAs. Row max and row sum reduce over
// the 16 lanes of a row group with shuffles. All accumulation is f32 in
// registers; dq needs no atomics (B2 owns a q tile and walks the k
// tiles, B3 owns a k tile and walks the q tiles), so results are
// deterministic. Tiles wholly above the causal diagonal are skipped when
// sk >= sq (no fully masked rows exist then).
//
// Masking follows the reference: an in-range masked score is -1e30 (not
// -inf), so a fully masked row averages every key as in the jnp path;
// keys past sk and queries past sq contribute exactly nothing.
//
// Dropout: keep(seed, bh, q, k) = murmur3_32 of the three little-endian
// 32-bit words (bh, q, k) under `seed`, compared with thresh =
// uint32((1 - p) * (2^32 - 1)). The mask is a function of the element,
// not of the tile, so the three kernels (and the plain PyTorch version,
// ops/fused_ops.py::_keep_mask) regenerate the same bits; the seed is
// read from device memory, never synchronised to the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows per q tile and per k tile
constexpr int kLd = kTile + 4;     // leading dim of [D][kTile], [kTile][kTile]
constexpr float kNegInf = -1e30f;  // the reference's mask fill (_NEG_INF)

enum { kQ = 0, kK = 1, kV = 2, kDo = 3, kO = 4, kO2 = 5 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* o;       // fwd: o; dq pass: dq; dkv pass: dk
  void* o2;      // dkv pass: dv
  float* lse;    // fwd output [b*h, sq]
  const float* lse_in;
  const float* delta;
  long long st[6][3];  // (batch, head, row) strides of q, k, v, do, o, o2
  int H, sq, sk, causal, dropout;
  float scale, inv_keep;
  uint32_t thresh;
  const long long* seed;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch
}

// -- the dropout hash: murmur3_32 over (bh, q, k) -----------------------
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}
__device__ __forceinline__ uint32_t mm3_round(uint32_t h, uint32_t w) {
  w *= 0xcc9e2d51u;
  w = rotl32(w, 15);
  w *= 0x1b873593u;
  h ^= w;
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}
__device__ __forceinline__ uint32_t mm3_final(uint32_t h) {
  h ^= 12u;  // message length in bytes
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}
// keep/(1-p) or 0 for the element whose (seed, bh, q) prefix is `qh`
__device__ __forceinline__ float drop_scale(uint32_t qh, int k,
                                            const Params& p) {
  return mm3_final(mm3_round(qh, static_cast<uint32_t>(k))) < p.thresh
             ? p.inv_keep
             : 0.f;
}

// -- shared-memory helpers ----------------------------------------------
__device__ __forceinline__ float4 ld4(const float* ptr) {
  return *reinterpret_cast<const float4*>(ptr);
}

// a thread's D/16 output columns: for D >= 64, 4-wide groups 64 apart
// (each 16-byte load of a half-warp covers 256 contiguous bytes)
template <int D>
__device__ __forceinline__ int out_col(int cb, int c) {
  constexpr int C = D / 16;
  if constexpr (C >= 4) {
    return (c / 4) * 64 + cb * 4 + (c % 4);
  } else {
    return cb * C + c;
  }
}

template <int D>
__device__ __forceinline__ void ld_cols(const float* row, int cb,
                                        float* out) {
  constexpr int C = D / 16;
  if constexpr (C >= 4) {
#pragma unroll
    for (int t = 0; t < C / 4; ++t) {
      const float4 x = ld4(row + t * 64 + cb * 4);
      out[4 * t] = x.x;
      out[4 * t + 1] = x.y;
      out[4 * t + 2] = x.z;
      out[4 * t + 3] = x.w;
    }
  } else {
    const float2 x = *reinterpret_cast<const float2*>(row + cb * C);
    out[0] = x.x;
    out[1] = x.y;
  }
}

// rows [r0, r0 + kTile) of x (row stride ss, rows >= n read as 0) into
// shared memory as f32: transposed tr[c * kLd + r] and/or row-major
// rw[r * (D + 4) + c] (either may be null)
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* x, long long ss, int r0,
                                          int n, float* tr, float* rw) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float val =
        (r0 + r < n) ? to_f32(x[static_cast<long long>(r0 + r) * ss + c])
                     : 0.f;
    if (tr != nullptr) tr[c * kLd + r] = val;
    if (rw != nullptr) rw[r * (D + 4) + c] = val;
  }
}

// acc[i][j] += sum_d A[d][ra*4 + i] * B[d][cb*4 + j]; A, B are [D][kLd]
template <int D>
__device__ __forceinline__ void mm_tt(const float* A, const float* B,
                                      int ra, int cb, float acc[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = ld4(A + d * kLd + ra * 4);
    const float4 b = ld4(B + d * kLd + cb * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// two products sharing the loop: s += A.B, t += C.E (all [D][kLd])
template <int D>
__device__ __forceinline__ void mm_tt2(const float* A, const float* B,
                                       const float* C, const float* E,
                                       int ra, int cb, float s[4][4],
                                       float t[4][4]) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a = ld4(A + d * kLd + ra * 4);
    const float4 b = ld4(B + d * kLd + cb * 4);
    const float4 c = ld4(C + d * kLd + ra * 4);
    const float4 e = ld4(E + d * kLd + cb * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
    const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        t[i][j] = fmaf(cv[i], ev[j], t[i][j]);
      }
  }
}

// acc[i][c] += sum_kk P[kk][ra*4 + i] * V[kk][out_col(cb, c)];
// P is [kTile][kLd], V is [kTile][D + 4]
template <int D>
__device__ __forceinline__ void mm_pv(const float* P, const float* V, int ra,
                                      int cb, float acc[4][D / 16]) {
  constexpr int C = D / 16;
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    const float4 a = ld4(P + kk * kLd + ra * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    float vv[C];
    ld_cols<D>(V + kk * (D + 4), cb, vv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = fmaf(av[i], vv[c], acc[i][c]);
  }
}

// store x[i][j] to P[(cb*4 + j) * kLd + ra*4 + i] (a transposed tile)
__device__ __forceinline__ void store_t(float* P, int ra, int cb,
                                        const float x[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(P + (cb * 4 + j) * kLd + ra * 4) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ const T* head(const void* base,
                                         const long long* st, int b,
                                         int h) {
  return static_cast<const T*>(base) + b * st[0] + h * st[1];
}

// number of k tiles a q tile starting at q0 needs
__device__ __forceinline__ int k_tiles(const Params& p, int q0) {
  const int n = (p.sk + kTile - 1) / kTile;
  const int off = p.sk - p.sq;
  if (p.causal && off >= 0) return min(n, (q0 + kTile - 1 + off) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------
// B1: forward
// ---------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * D * kLd + kTile * (D + 4) + kTile * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params p) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + D * kLd;
  float* Vs = Kt + D * kLd;
  float* Pt = Vs + kTile * (D + 4);
  const int tid = threadIdx.x, ra = tid >> 4, cb = tid & 15;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const int off = p.sk - p.sq;

  load_tile<T, D>(q, p.st[kQ][2], q0, p.sq, Qt, nullptr);
  float m[4], l[4], acc[4][C];
  uint32_t qh[4];
  const uint32_t hb =
      p.dropout ? mm3_round(static_cast<uint32_t>(*p.seed), bh) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qh[i] = mm3_round(hb, static_cast<uint32_t>(q0 + ra * 4 + i));
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int n_k = k_tiles(p, q0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's Kt / Vs / Pt reads are done
    load_tile<T, D>(k, p.st[kK][2], k0, p.sk, Kt, nullptr);
    load_tile<T, D>(v, p.st[kV][2], k0, p.sk, nullptr, Vs);
    __syncthreads();
    float s[4][4] = {};
    mm_tt<D>(Qt, Kt, ra, cb, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ra * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cb * 4 + j;
        float x;
        if (col >= p.sk)
          x = -INFINITY;  // past the keys: contributes nothing
        else if (p.causal && row + off < col)
          x = kNegInf;
        else
          x = s[i][j] * p.scale;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // l sums the undropped p; the values see p * keep / (1 - p)
        const float e = expf(s[i][j] - m_new);
        sum += e;
        s[i][j] = p.dropout ? e * drop_scale(qh[i], k0 + cb * 4 + j, p) : e;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    store_t(Pt, ra, cb, s);
    __syncthreads();
    mm_pv<D>(Pt, Vs, ra, cb, acc);
  }

  T* o = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra * 4 + i;
    if (row >= p.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[row * p.st[kO][2] + out_col<D>(cb, c)] =
          from_f32<T>(acc[i][c] / l_safe);
    if (cb == 0)
      p.lse[static_cast<long long>(bh) * p.sq + row] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------
// B2: backward dq
// ---------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * D * kLd + kTile * (D + 4) + kTile * kLd);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(const Params p) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* dOt = Qt + D * kLd;
  float* Kt = dOt + D * kLd;
  float* Vt = Kt + D * kLd;
  float* Ks = Vt + D * kLd;
  float* dSt = Ks + kTile * (D + 4);
  const int tid = threadIdx.x, ra = tid >> 4, cb = tid & 15;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const T* dout = head<T>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;

  load_tile<T, D>(q, p.st[kQ][2], q0, p.sq, Qt, nullptr);
  load_tile<T, D>(dout, p.st[kDo][2], q0, p.sq, dOt, nullptr);
  float lse[4], delta[4], acc[4][C];
  uint32_t qh[4];
  const uint32_t hb =
      p.dropout ? mm3_round(static_cast<uint32_t>(*p.seed), bh) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra * 4 + i;
    const long long at = static_cast<long long>(bh) * p.sq + row;
    lse[i] = row < p.sq ? p.lse_in[at] : 0.f;
    delta[i] = row < p.sq ? p.delta[at] : 0.f;
    qh[i] = mm3_round(hb, static_cast<uint32_t>(row));
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int n_k = k_tiles(p, q0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(k, p.st[kK][2], k0, p.sk, Kt, Ks);
    load_tile<T, D>(v, p.st[kV][2], k0, p.sk, Vt, nullptr);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_tt2<D>(Qt, Kt, dOt, Vt, ra, cb, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ra * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cb * 4 + j;
        float ds = 0.f;
        if (col < p.sk && row < p.sq) {
          const float x =
              (p.causal && row + off < col) ? kNegInf : s[i][j] * p.scale;
          const float pij = expf(x - lse[i]);
          const float dpv =
              p.dropout ? dp[i][j] * drop_scale(qh[i], col, p) : dp[i][j];
          ds = pij * (dpv - delta[i]);
        }
        s[i][j] = ds;
      }
    }
    store_t(dSt, ra, cb, s);
    __syncthreads();
    mm_pv<D>(dSt, Ks, ra, cb, acc);
  }

  T* dq = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra * 4 + i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dq[row * p.st[kO][2] + out_col<D>(cb, c)] =
          from_f32<T>(acc[i][c] * p.scale);
  }
}

// ---------------------------------------------------------------------
// B3: backward dk, dv
// ---------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * D * kLd + 2 * kTile * (D + 4) + kTile * kLd + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(const Params p) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);
  float* Vt = Kt + D * kLd;
  float* Qt = Vt + D * kLd;
  float* dOt = Qt + D * kLd;
  float* Qs = dOt + D * kLd;
  float* dOs = Qs + kTile * (D + 4);
  float* Ps = dOs + kTile * (D + 4);  // [q][k]
  float* lse_s = Ps + kTile * kLd;
  float* delta_s = lse_s + kTile;
  const int tid = threadIdx.x, ra = tid >> 4, cb = tid & 15;
  const int k0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const T* dout = head<T>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;

  load_tile<T, D>(k, p.st[kK][2], k0, p.sk, Kt, nullptr);
  load_tile<T, D>(v, p.st[kV][2], k0, p.sk, Vt, nullptr);
  float acck[4][C], accv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acck[i][c] = accv[i][c] = 0.f;
  const uint32_t hb =
      p.dropout ? mm3_round(static_cast<uint32_t>(*p.seed), bh) : 0u;

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int qt0 = (p.causal && off >= 0) ? max(0, k0 - off) / kTile : 0;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(q, p.st[kQ][2], q0, p.sq, Qt, Qs);
    load_tile<T, D>(dout, p.st[kDo][2], q0, p.sq, dOt, dOs);
    if (tid < kTile) {
      const int row = q0 + tid;
      const long long at = static_cast<long long>(bh) * p.sq + row;
      lse_s[tid] = row < p.sq ? p.lse_in[at] : 0.f;
      delta_s[tid] = row < p.sq ? p.delta[at] : 0.f;
    }
    __syncthreads();
    // transposed scores: s[i][j] for key k0 + ra*4 + i, query q0 + cb*4 + j
    float s[4][4] = {}, dp[4][4] = {};
    mm_tt2<D>(Kt, Qt, Vt, dOt, ra, cb, s, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qcol = q0 + cb * 4 + j;
      const uint32_t qh = mm3_round(hb, static_cast<uint32_t>(qcol));
      const float lse = lse_s[cb * 4 + j], delta = delta_s[cb * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = k0 + ra * 4 + i;
        float pd = 0.f, ds = 0.f;
        if (qcol < p.sq && krow < p.sk) {
          const float x =
              (p.causal && qcol + off < krow) ? kNegInf : s[i][j] * p.scale;
          const float pij = expf(x - lse);
          const float dm = p.dropout ? drop_scale(qh, krow, p) : 1.f;
          pd = pij * dm;
          ds = pij * (dp[i][j] * dm - delta);
        }
        s[i][j] = pd;
        dp[i][j] = ds;
      }
    }
    // Ps[q][k]: store_t writes P[(cb*4 + j) * kLd + ra*4 + i]
    store_t(Ps, ra, cb, s);
    __syncthreads();
    mm_pv<D>(Ps, dOs, ra, cb, accv);
    __syncthreads();
    store_t(Ps, ra, cb, dp);
    __syncthreads();
    mm_pv<D>(Ps, Qs, ra, cb, acck);
  }

  T* dk = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
  T* dv = const_cast<T*>(head<T>(p.o2, p.st[kO2], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ra * 4 + i;
    if (row >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = out_col<D>(cb, c);
      dk[row * p.st[kO][2] + col] = from_f32<T>(acck[i][c] * p.scale);
      dv[row * p.st[kO2][2] + col] = from_f32<T>(accv[i][c]);
    }
  }
}

// the keep mask itself, for checking the hash against the plain version
__global__ void keep_mask_kernel(uint8_t* out, int BH, int sq, int sk,
                                 uint32_t thresh, const long long* seed) {
  const long long n = static_cast<long long>(BH) * sq * sk;
  const uint32_t s = static_cast<uint32_t>(*seed);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int kk = static_cast<int>(i % sk);
    const long long r = i / sk;
    const int qq = static_cast<int>(r % sq);
    const int bh = static_cast<int>(r / sq);
    const uint32_t hsh = mm3_final(mm3_round(
        mm3_round(mm3_round(s, bh), static_cast<uint32_t>(qq)),
        static_cast<uint32_t>(kk)));
    out[i] = hsh < thresh ? 1 : 0;
  }
}

template <typename T, int D>
cudaError_t launch(int pass, const Params& p, int B, cudaStream_t stream) {
  const int tiles = ((pass == 2 ? p.sk : p.sq) + kTile - 1) / kTile;
  const dim3 grid(tiles, B * p.H);
  void (*kern)(const Params);
  size_t bytes;
  if (pass == 0) {
    kern = fwd_kernel<T, D>;
    bytes = fwd_smem<D>();
  } else if (pass == 1) {
    kern = dq_kernel<T, D>;
    bytes = dq_smem<D>();
  } else {
    kern = dkv_kernel<T, D>;
    bytes = dkv_smem<D>();
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// pass: 0 forward (B1), 1 dq (B2), 2 dk/dv (B3); dtype: 0 f32, 1 bf16.
// `strides`: 18 host values, (batch, head, row) element strides of q,
// k, v, do, out, out2. Returns cudaGetLastError() of the launch.
extern "C" int flash_attn(int pass, int dtype, int d, const void* q,
                          const void* k, const void* v, const void* dout,
                          void* out, void* out2, float* lse,
                          const float* lse_in, const float* delta,
                          const long long* strides, int B, int H, int sq,
                          int sk, float scale, int causal, int dropout,
                          float inv_keep, unsigned thresh,
                          const long long* seed, int num_sms, void* stream) {
  (void)num_sms;
  if (pass < 0 || pass > 2 || B * H > 65535) return cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.o = out;
  p.o2 = out2;
  p.lse = lse;
  p.lse_in = lse_in;
  p.delta = delta;
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[i * 3 + j];
  p.H = H;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.dropout = dropout;
  p.scale = scale;
  p.inv_keep = inv_keep;
  p.thresh = thresh;
  p.seed = seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype * 1000 + d) {
    case 32: err = launch<float, 32>(pass, p, B, st); break;
    case 64: err = launch<float, 64>(pass, p, B, st); break;
    case 128: err = launch<float, 128>(pass, p, B, st); break;
    case 1032: err = launch<__nv_bfloat16, 32>(pass, p, B, st); break;
    case 1064: err = launch<__nv_bfloat16, 64>(pass, p, B, st); break;
    case 1128: err = launch<__nv_bfloat16, 128>(pass, p, B, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_keep_mask(uint8_t* out, int BH, int sq, int sk,
                               unsigned thresh, const long long* seed,
                               int num_sms, void* stream) {
  keep_mask_kernel<<<num_sms * 4, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(out, BH, sq, sk,
                                                          thresh, seed);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
