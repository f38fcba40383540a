// Flash attention forward and backward for Hopper (sm_90a), on
// [b, h, s, d] tensors addressed through (batch, head, row) element
// strides with a contiguous last dim, in f32, bf16 or f16, head dim 32, 64
// or 128, any sq and sk (ragged against the 64-row tiles), causal mask
// aligned bottom-right (query i sees keys <= i + sk - sq), in-kernel
// attention dropout.
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/fused_ops.py:
//   B1 `_fwd_kernel` (:184)      -> fwd_kernel_mma (16-bit), fwd_kernel (f32):
//                                   o and lse = m + log(l)
//   B2 `_bwd_dq_kernel` (:319)   -> dq_kernel_mma (16-bit), dq_kernel (f32):
//                                   dq = scale * sum_k ds * k
//   B3 `_bwd_dkv_kernel` (:363)  -> dkv_kernel_mma (16-bit), dkv_kernel
//                                   (f32):
//                                   dv = pd^T do, dk = scale * ds^T q
// with p recomputed from lse, ds = p * (dp * keep/(1-p) - delta), delta
// = rowsum(do * o) computed by the wrapper.
//
// Bound: at the ERNIE shape (b*h = 384, s = 512, d = 64, bf16) B1
// moves 101 MB for 25.8 GFLOP (bytes: 0.030 ms at 3.35 TB/s, the
// products 0.026 ms at 989 TFLOP/s), B2 127 MB for 38.7 GFLOP
// (operations: 0.039 ms), B3 151 MB for 51.5 GFLOP (operations: 0.052
// ms). Next to the products every score costs an exp and, with dropout,
// a murmur3 hash (~12 integer operations) on the CUDA cores, ~100 M of
// each a pass.
//
// bf16 (the train step under O1) runs all three on the tensor cores:
// mma.sync m16n8k16 bf16 -> f32 with ldmatrix fragments (.trans for the
// [k][n] operands), operands staged as bf16 by a two-stage cp.async
// ring, scores, softmax and gradients in f32 registers (see the section
// below). B1 rounds p to bf16 before its value product as the
// reference's kernel does (there divided by the running sum, so a row
// within one tile sees exactly the plain version's probabilities); B2
// and B3 recompute p from lse with the same instructions and round ds
// (and B3 p * keep/(1-p)) to bf16 before their products, as the plain
// version does. f16 (the train step under float16 amp) runs the same
// kernels instantiated on __half (mma.sync .f16, the fragment layout of
// .bf16; csrc/half16.cuh), with the same f32 accumulation and the same
// rounding points, now to f16: where the loss scale makes ds exceed
// 65504 it rounds to inf as the reference's astype does, and the
// scaler skips the step. The dropout hash is split: the (seed, bh) and (seed,
// bh, q) rounds are hoisted, each column's k word is mixed once a tile,
// and each tile's keep bits are hashed while its copy is in flight.
//
// f32 keeps the first design, in full f32 on the CUDA cores (no TF32):
// one block of 256 threads per (64-row tile, b*h); resident operands in
// shared memory as f32, streamed ones staged one 64-row tile at a time;
// each thread owns a 4x4 block of the 64x64 score tile (row group = tid
// / 16, column group = tid % 16) and 4 rows x d/16 columns of the
// output tile, so every inner step is two 16-byte shared-memory loads
// feeding 16 FMAs; row max and row sum reduce over the 16 lanes of a
// row group with shuffles.
//
// Every kernel owns its output tile (B2 a q tile walking the k tiles, B3
// a k tile walking the q tiles), accumulates in f32 registers and needs
// no atomics, so results are deterministic. Tiles wholly above the
// causal diagonal are skipped when sk >= sq (no fully masked rows exist
// then).
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
// read from device memory, never synchronised to the host. bh is the
// global batch-head index (drop_bh): a rank holding some rows of the
// batch or some of the heads (data or model parallelism) drops the same
// elements as one device holding them all.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "half16.cuh"

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
  int b0, h0, Hg;  // the dropout hash's global batch / head offsets, heads
};

// -- the dropout hash: murmur3_32 over (bh, q, k) -----------------------
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}
// a round's word mix, which depends on the word alone (the tensor-core
// kernels compute the k words once per tile and share them over rows)
__device__ __forceinline__ uint32_t mm3_word(uint32_t w) {
  w *= 0xcc9e2d51u;
  w = rotl32(w, 15);
  return w * 0x1b873593u;
}
__device__ __forceinline__ uint32_t mm3_round(uint32_t h, uint32_t w) {
  h ^= mm3_word(w);
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
// the dropout hash's bh word: the element's GLOBAL batch-head index,
// (b0 + b) * Hg + h0 + h for this launch's row b and head h, where b0 and
// h0 place this rank's rows and heads in the whole batch of Hg heads (b0
// = h0 = 0, Hg = H: the launch's own bh)
__device__ __forceinline__ uint32_t drop_bh(const Params& p, int b, int h) {
  return static_cast<uint32_t>((b + p.b0) * p.Hg + p.h0 + h);
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
template <int D>
__device__ __forceinline__ void load_tile(const float* x, long long ss,
                                          int r0, int n, float* tr,
                                          float* rw) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float val =
        (r0 + r < n) ? x[static_cast<long long>(r0 + r) * ss + c]
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

template <int D>
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
  const float* q = head<float>(p.q, p.st[kQ], b, h);
  const float* k = head<float>(p.k, p.st[kK], b, h);
  const float* v = head<float>(p.v, p.st[kV], b, h);
  const int off = p.sk - p.sq;

  load_tile<D>(q, p.st[kQ][2], q0, p.sq, Qt, nullptr);
  float m[4], l[4], acc[4][C];
  uint32_t qh[4];
  const uint32_t hb =
      p.dropout
          ? mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h))
          : 0u;
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
    load_tile<D>(k, p.st[kK][2], k0, p.sk, Kt, nullptr);
    load_tile<D>(v, p.st[kV][2], k0, p.sk, nullptr, Vs);
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

  float* o = const_cast<float*>(head<float>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra * 4 + i;
    if (row >= p.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[row * p.st[kO][2] + out_col<D>(cb, c)] =
          acc[i][c] / l_safe;
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

template <int D>
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
  const float* q = head<float>(p.q, p.st[kQ], b, h);
  const float* k = head<float>(p.k, p.st[kK], b, h);
  const float* v = head<float>(p.v, p.st[kV], b, h);
  const float* dout = head<float>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;

  load_tile<D>(q, p.st[kQ][2], q0, p.sq, Qt, nullptr);
  load_tile<D>(dout, p.st[kDo][2], q0, p.sq, dOt, nullptr);
  float lse[4], delta[4], acc[4][C];
  uint32_t qh[4];
  const uint32_t hb =
      p.dropout
          ? mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h))
          : 0u;
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
    load_tile<D>(k, p.st[kK][2], k0, p.sk, Kt, Ks);
    load_tile<D>(v, p.st[kV][2], k0, p.sk, Vt, nullptr);
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

  float* dq = const_cast<float*>(head<float>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra * 4 + i;
    if (row >= p.sq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      dq[row * p.st[kO][2] + out_col<D>(cb, c)] =
          acc[i][c] * p.scale;
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

template <int D>
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
  const float* q = head<float>(p.q, p.st[kQ], b, h);
  const float* k = head<float>(p.k, p.st[kK], b, h);
  const float* v = head<float>(p.v, p.st[kV], b, h);
  const float* dout = head<float>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;

  load_tile<D>(k, p.st[kK][2], k0, p.sk, Kt, nullptr);
  load_tile<D>(v, p.st[kV][2], k0, p.sk, Vt, nullptr);
  float acck[4][C], accv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) acck[i][c] = accv[i][c] = 0.f;
  const uint32_t hb =
      p.dropout
          ? mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h))
          : 0u;

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int qt0 = (p.causal && off >= 0) ? max(0, k0 - off) / kTile : 0;
  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<D>(q, p.st[kQ][2], q0, p.sq, Qt, Qs);
    load_tile<D>(dout, p.st[kDo][2], q0, p.sq, dOt, dOs);
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

  float* dk = const_cast<float*>(head<float>(p.o, p.st[kO], b, h));
  float* dv = const_cast<float*>(head<float>(p.o2, p.st[kO2], b, h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ra * 4 + i;
    if (row >= p.sk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = out_col<D>(cb, c);
      dk[row * p.st[kO][2] + col] = acck[i][c] * p.scale;
      dv[row * p.st[kO2][2] + col] = accv[i][c];
    }
  }
}

// ---------------------------------------------------------------------
// bf16 and f16 on the tensor cores: B1 (fwd_kernel_mma), B2
// (dq_kernel_mma) and B3 (dkv_kernel_mma)
// ---------------------------------------------------------------------
// Four warps a block; each owns 16 rows of the block's 64-row tile (B1,
// B2: queries, B3: keys) and multiplies with mma.sync m16n8k16 (T = bf16
// or f16 in, f32 accumulators). Operand tiles sit in shared memory as T
// [64][D + 8]:
// the 16-byte row pad puts the 8 row addresses of every ldmatrix phase
// in 8 distinct 16-byte bank groups. The streamed tiles come through a
// two-stage cp.async ring (tile i + 1 is copied while tile i computes);
// rows past sq / sk are zero-filled by the copy itself. (Eight warps and
// 128-row blocks were tried on the H100 and were no faster.)

constexpr int kThreadsTc = 128;
constexpr int kNt = kTile / 8;  // n8 tiles across a 64-wide score tile
typedef __nv_bfloat16 bf16;
typedef __half f16;
using half16::mma16816;
using half16::pack2;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 (or 4) bytes global -> shared; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed (in this thread's view)
__device__ __forceinline__ void cp_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The A operand of a k16 step of a product whose left factor is the f32
// accumulator tile x [16][64] of the previous product (columns 16 kk ..
// 16 kk + 15): the m16n8 accumulator layout of n-tiles 2 kk and 2 kk + 1
// is the m16k16 A layout, so each lane repacks its own values.
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&x)[kNt][4], int kk,
                                         uint32_t (&a)[4]) {
  a[0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// keep bit of the element whose (seed, bh, q) prefix is qh and whose k
// word mix is kw (mm3_word(k)): drop_scale's hash, split so that the
// k half is computed once a column
__device__ __forceinline__ bool keep_bit(uint32_t qh, uint32_t kw,
                                         uint32_t thresh) {
  uint32_t h = rotl32(qh ^ kw, 13) * 5u + 0xe6546b64u;
  return mm3_final(h) < thresh;
}

// rows [r0, r0 + kTile) of x (row stride ss, 16-byte aligned rows; rows
// >= n zero-filled) into the 16-bit tile [kTile][D + 8] at shared dst
template <int D, typename T>
__device__ __forceinline__ void cp_tile(uint32_t dst, const T* x,
                                        long long ss, int r0, int n) {
  constexpr int kCh = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int it = 0; it < kTile * kCh / kThreadsTc; ++it) {
    const int i = it * kThreadsTc + threadIdx.x;
    const int r = i / kCh, c = i % kCh;
    const bool ok = r0 + r < n;
    const T* src = x + (ok ? static_cast<long long>(r0 + r) * ss + c * 8
                              : 0);
    cp_async16(dst + (r * (D + 8) + c * 8) * 2, src, ok);
  }
}

// This lane's byte offsets inside a [kTile][D + 8] tile for ldmatrix x4:
// a_off addresses rows lane % 16, columns 8 (lane / 16): an A fragment
// (16 rows x k16) or, with .trans, a B fragment of two n8 tiles from a
// [k][n] row-major tile; b_off addresses rows 8 (lane / 16) + lane % 8,
// columns 8 ((lane / 8) % 2): a B fragment of two n8 tiles (16 rows) x
// k16 from an [n][k] row-major tile.
template <int D>
__device__ __forceinline__ uint32_t a_off(int lane) {
  return ((lane & 15) * (D + 8) + (lane >> 4) * 8) * 2;
}
template <int D>
__device__ __forceinline__ uint32_t b_off(int lane) {
  return (((lane >> 4) * 8 + (lane & 7)) * (D + 8) + ((lane >> 3) & 1) * 8) *
         2;
}
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return kTile * (D + 8) * 2;
}

// s[16 x 64] += A[16 x D] B^T, A the warp's rows of tile `a_s`, B all 64
// rows of tile `b_s` (both [kTile][D + 8])
template <int D, typename T>
__device__ __forceinline__ void mm_abt(uint32_t a_s, uint32_t b_s, int warp,
                                       int lane, float (&s)[kNt][4]) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm4(a_s + (warp * 16 * (D + 8) + ks * 16) * 2 + a_off<D>(lane), a);
#pragma unroll
    for (int jj = 0; jj < kNt / 2; ++jj) {
      uint32_t bb[4];
      ldsm4(b_s + (jj * 16 * (D + 8) + ks * 16) * 2 + b_off<D>(lane), bb);
      mma16816<T>(s[2 * jj], a, bb[0], bb[1]);
      mma16816<T>(s[2 * jj + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[16 x D] += X[16 x 64] B, X a register tile (rounded to T by
// acc_to_a), B the 64 x D tile `b_s`
template <int D, typename T>
__device__ __forceinline__ void mm_xb(const float (&x)[kNt][4], uint32_t b_s,
                                      int lane, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    uint32_t a[4];
    acc_to_a<T>(x, kk, a);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bb[4];
      ldsm4_t(b_s + (kk * 16 * (D + 8) + dd * 16) * 2 + a_off<D>(lane), bb);
      mma16816<T>(acc[2 * dd], a, bb[0], bb[1]);
      mma16816<T>(acc[2 * dd + 1], a, bb[2], bb[3]);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
constexpr size_t fwd_mma_smem() {
  return 5 * tile_bytes<D>();  // Q, K x 2 stages, V x 2 stages
}

// B1 in T. Lane (g = lane / 4, t = lane % 4) of warp w holds rows
// q0 + 16 w + g (+ 8) and, of every n8 tile j, columns 8 j + 2 t (+ 1).
// Scores live in the log2 domain (x2 = s * scale * log2 e, so exp is one
// ex2); the masked score is -1e30 in natural units.
// Register budget: 128 at d <= 64 (four blocks an SM; on the H100
// faster than three blocks at 148 registers), 255 at d = 128 (two).
template <int D, typename T>
__global__ void __launch_bounds__(kThreadsTc, D <= 64 ? 4 : 2)
    fwd_kernel_mma(const Params p) {
  constexpr int NO = D / 8;
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ float4 smem4[];
  const uint32_t q_s = smem_addr(smem4);
  const uint32_t k_s = q_s + TB;       // two stages
  const uint32_t v_s = k_s + 2 * TB;   // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const int off = p.sk - p.sq;
  const int n_k = k_tiles(p, q0);
  const int row0 = q0 + warp * 16 + g;
  const float scale2 = p.scale * kLog2e;
  const float masked2 = kNegInf * kLog2e;

  cp_tile<D>(q_s, q, p.st[kQ][2], q0, p.sq);
  cp_tile<D>(k_s, k, p.st[kK][2], 0, p.sk);
  cp_tile<D>(v_s, v, p.st[kV][2], 0, p.sk);
  cp_commit();

  uint32_t qh[2] = {0u, 0u};
  if (p.dropout) {
    const uint32_t hb =
        mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h));
    qh[0] = mm3_round(hb, static_cast<uint32_t>(row0));
    qh[1] = mm3_round(hb, static_cast<uint32_t>(row0 + 8));
  }
  float m[2] = {masked2, masked2}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    const uint32_t cur = (kt & 1) * TB;
    if (kt + 1 < n_k) {
      const uint32_t nxt = TB - cur;
      cp_tile<D>(k_s + nxt, k, p.st[kK][2], k0 + kTile, p.sk);
      cp_tile<D>(v_s + nxt, v, p.st[kV][2], k0 + kTile, p.sk);
    }
    cp_commit();
    // the tile's keep bits (bit 4 j + e) need no shared memory: hashed
    // while the copy is in flight, each column's k word once for both rows
    uint32_t keep = ~0u;
    if (p.dropout) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        const uint32_t kw[2] = {mm3_word(static_cast<uint32_t>(col)),
                                mm3_word(static_cast<uint32_t>(col + 1))};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= static_cast<uint32_t>(
                      keep_bit(qh[e >> 1], kw[e & 1], p.thresh))
                  << (j * 4 + e);
      }
    }
    cp_wait_prev();
    __syncthreads();

    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mm_abt<D, T>(q_s, k_s + cur, warp, lane, s);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (k0 + kTile > p.sk || (p.causal && q0 + off < k0 + kTile - 1)) {
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= p.sk)
            s[j][e] = -INFINITY;  // past the keys: contributes nothing
          else if (p.causal && row + off < col)
            s[j][e] = masked2;
        }
    }
    // online softmax over the quad of lanes that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(s[j][e] - m[e >> 1]);
        lsum[e >> 1] += s[j][e];
      }
    // p is rounded to T divided by the running sum l (the undropped
    // p's, >= 1 since the row's maximum contributes 1), and the output
    // carried in the same units: in a row within one tile the values see
    // exactly the plain version's probabilities
    float f[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 1);
      lsum[i] += __shfl_xor_sync(0xffffffffu, lsum[i], 2);
      const float carried = l[i] * alpha[i];
      l[i] = carried + lsum[i];
      const float inv = 1.f / l[i];
      f[i] = p.inv_keep * inv;
      const float r = carried * inv;
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[c][2 * i] *= r;
        acc[c][2 * i + 1] *= r;
      }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = (keep >> (j * 4 + e)) & 1u ? s[j][e] * f[e >> 1] : 0.f;
    mm_xb<D, T>(s, v_s + cur, lane, acc);
    __syncthreads();  // every warp is done with stage `cur` before refill
  }

  T* o = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.sq) continue;
    T* orow = o + row * p.st[kO][2] + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(orow + c * 8) =
          pack2<T>(acc[c][2 * i], acc[c][2 * i + 1]);
    // a fully masked row keeps lse at exactly -1e30 (log l is below its
    // ulp), as the plain version's m + log(l)
    if (t == 0)
      p.lse[static_cast<long long>(bh) * p.sq + row] =
          (m[i] == masked2 ? kNegInf : m[i] * kLn2) + logf(l[i]);
  }
}

template <int D>
constexpr size_t dkv_mma_smem() {
  // K, V, Q x 2 stages, dO x 2 stages, then per stage lse, delta and the
  // dropout hash prefixes of the tile's 64 queries
  return 6 * tile_bytes<D>() + 2 * 3 * kTile * sizeof(float);
}

// B3 in T: the block owns 64 keys and walks the q tiles. Lane (g, t)
// of warp w holds key rows k0 + 16 w + g (+ 8) and, of every n8 tile j,
// query columns 8 j + 2 t (+ 1) of the transposed score tile.
// Register budget: 255, two blocks an SM (a three-block budget of 168
// spills and was slower on the H100); d = 128 spills 32 bytes.
template <int D, typename T>
__global__ void __launch_bounds__(kThreadsTc, 2)
    dkv_kernel_mma(const Params p) {
  constexpr int NO = D / 8;
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ float4 smem4[];
  const uint32_t k_s = smem_addr(smem4);
  const uint32_t v_s = k_s + TB;
  const uint32_t q_s = v_s + TB;        // two stages
  const uint32_t do_s = q_s + 2 * TB;   // two stages
  float* rows_s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + 6 * TB);  // [2][3][kTile]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const T* dout = head<T>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;
  const int krow0 = k0 + warp * 16 + g;
  const long long row_base = static_cast<long long>(bh) * p.sq;
  const float scale2 = p.scale * kLog2e;
  const uint32_t hb =
      p.dropout
          ? mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h))
          : 0u;

  // q tile qt into ring slot `slot`: Q, dO and the lse / delta rows
  // (zeros past sq) by cp.async, the queries' hash prefixes stored
  auto fill = [&](int qt, int slot) {
    const int r0 = qt * kTile;
    cp_tile<D>(q_s + slot * TB, q, p.st[kQ][2], r0, p.sq);
    cp_tile<D>(do_s + slot * TB, dout, p.st[kDo][2], r0, p.sq);
    float* rs = rows_s + slot * 3 * kTile;
    const int r = r0 + (tid & (kTile - 1));
    const bool ok = r < p.sq;
    const float* src =
        (tid < kTile ? p.lse_in : p.delta) + (ok ? row_base + r : 0);
    cp_async4(smem_addr(rs + tid), src, ok);  // lse [0, 64), delta [64, 128)
    if (p.dropout && tid < kTile)
      reinterpret_cast<uint32_t*>(rs)[2 * kTile + tid] =
          mm3_round(hb, static_cast<uint32_t>(r));
  };

  const int n_q = (p.sq + kTile - 1) / kTile;
  const int qt0 = (p.causal && off >= 0) ? max(0, k0 - off) / kTile : 0;
  cp_tile<D>(k_s, k, p.st[kK][2], k0, p.sk);
  cp_tile<D>(v_s, v, p.st[kV][2], k0, p.sk);
  fill(qt0, 0);
  cp_commit();
  __syncthreads();  // the first tile's hash prefixes

  uint32_t kw[2] = {0u, 0u};
  if (p.dropout) {
    kw[0] = mm3_word(static_cast<uint32_t>(krow0));
    kw[1] = mm3_word(static_cast<uint32_t>(krow0 + 8));
  }
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int qt = qt0; qt < n_q; ++qt) {
    const int q0 = qt * kTile, slot = (qt - qt0) & 1;
    if (qt + 1 < n_q) fill(qt + 1, slot ^ 1);
    cp_commit();
    const float* lse_t = rows_s + slot * 3 * kTile;
    const float* delta_t = lse_t + kTile;
    // the tile's keep bits (bit 4 j + e), hashed while the copy is in
    // flight from prefixes stored before the last barrier
    uint32_t keep = ~0u;
    if (p.dropout) {
      const uint32_t* qh_t =
          reinterpret_cast<const uint32_t*>(lse_t + 2 * kTile);
      keep = 0u;
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= static_cast<uint32_t>(keep_bit(qh_t[j * 8 + 2 * t + (e & 1)],
                                                 kw[e >> 1], p.thresh))
                  << (j * 4 + e);
    }
    cp_wait_prev();
    __syncthreads();
    const uint32_t qs = q_s + slot * TB, dos = do_s + slot * TB;

    // P^T = exp(scale K Q^T - lse)
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mm_abt<D, T>(k_s, qs, warp, lane, s);
    const bool edge = p.causal && q0 + off < k0 + kTile - 1;
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = j * 8 + 2 * t + e;
        const float lse = lse_t[cc], lse2 = lse * kLog2e;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = fmaf(s[j][2 * i + e], scale2, -lse2);
          // a masked score is -1e30: exp(-1e30 - lse), 1 in a fully
          // masked row (lse = -1e30) as in the plain version
          if (edge && q0 + cc + off < krow0 + i * 8)
            x = (kNegInf - lse) * kLog2e;
          s[j][2 * i + e] = ex2(x);
        }
      }

    // dV += P_d^T dO with P_d = P keep / (1 - p), rounded to T
    {
      float pd[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pd[j][e] =
              (keep >> (j * 4 + e)) & 1u ? s[j][e] * p.inv_keep : 0.f;
      mm_xb<D, T>(pd, dos, lane, dv);
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T keep / (1 - p) - delta)
    float ds[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    mm_abt<D, T>(v_s, dos, warp, lane, ds);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dpv =
            (keep >> (j * 4 + e)) & 1u ? ds[j][e] * p.inv_keep : 0.f;
        ds[j][e] = s[j][e] * (dpv - delta_t[j * 8 + 2 * t + (e & 1)]);
      }
    // dK += dS^T Q (dS rounded to T; scaled at the end)
    mm_xb<D, T>(ds, qs, lane, dk);
    __syncthreads();  // every warp is done with slot `slot` before refill
  }

  T* dkp = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
  T* dvp = const_cast<T*>(head<T>(p.o2, p.st[kO2], b, h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = krow0 + 8 * i;
    if (row >= p.sk) continue;
    T* dkr = dkp + row * p.st[kO][2] + 2 * t;
    T* dvr = dvp + row * p.st[kO2][2] + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      *reinterpret_cast<uint32_t*>(dkr + c * 8) = pack2<T>(
          dk[c][2 * i] * p.scale, dk[c][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvr + c * 8) =
          pack2<T>(dv[c][2 * i], dv[c][2 * i + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_mma_smem() {
  return 6 * tile_bytes<D>();  // Q, dO, K x 2 stages, V x 2 stages
}

// B2 in T: the block owns 64 queries and walks the k tiles. Lane (g,
// t) of warp w holds query rows q0 + 16 w + g (+ 8) and, of every n8
// tile j, key columns 8 j + 2 t (+ 1), as in B1. p is recomputed from
// lse exactly as B3 recomputes it; ds = p (dp keep / (1 - p) - delta)
// is rounded to T by acc_to_a on its way into dQ += dS K.
// Register budget: 170 at d <= 64 (three blocks an SM), 255 at d = 128.
template <int D, typename T>
__global__ void __launch_bounds__(kThreadsTc, D <= 64 ? 3 : 2)
    dq_kernel_mma(const Params p) {
  constexpr int NO = D / 8;
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ float4 smem4[];
  const uint32_t q_s = smem_addr(smem4);
  const uint32_t do_s = q_s + TB;
  const uint32_t k_s = do_s + TB;      // two stages
  const uint32_t v_s = k_s + 2 * TB;   // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const T* q = head<T>(p.q, p.st[kQ], b, h);
  const T* k = head<T>(p.k, p.st[kK], b, h);
  const T* v = head<T>(p.v, p.st[kV], b, h);
  const T* dout = head<T>(p.dout, p.st[kDo], b, h);
  const int off = p.sk - p.sq;
  const int n_k = k_tiles(p, q0);
  const int row0 = q0 + warp * 16 + g;
  const float scale2 = p.scale * kLog2e;

  cp_tile<D>(q_s, q, p.st[kQ][2], q0, p.sq);
  cp_tile<D>(do_s, dout, p.st[kDo][2], q0, p.sq);
  cp_tile<D>(k_s, k, p.st[kK][2], 0, p.sk);
  cp_tile<D>(v_s, v, p.st[kV][2], 0, p.sk);
  cp_commit();

  // the two rows' lse, lse in log2 units and delta (zeros past sq)
  float lse[2], lse2[2], delta[2];
  uint32_t qh[2] = {0u, 0u};
  const uint32_t hb =
      p.dropout
          ? mm3_round(static_cast<uint32_t>(*p.seed), drop_bh(p, b, h))
          : 0u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const long long at = static_cast<long long>(bh) * p.sq + row;
    lse[i] = row < p.sq ? p.lse_in[at] : 0.f;
    lse2[i] = lse[i] * kLog2e;
    delta[i] = row < p.sq ? p.delta[at] : 0.f;
    if (p.dropout) qh[i] = mm3_round(hb, static_cast<uint32_t>(row));
  }
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    const uint32_t cur = (kt & 1) * TB;
    if (kt + 1 < n_k) {
      const uint32_t nxt = TB - cur;
      cp_tile<D>(k_s + nxt, k, p.st[kK][2], k0 + kTile, p.sk);
      cp_tile<D>(v_s + nxt, v, p.st[kV][2], k0 + kTile, p.sk);
    }
    cp_commit();
    // the tile's keep bits (bit 4 j + e), hashed while the copy is in
    // flight, each column's k word once for both rows
    uint32_t keep = ~0u;
    if (p.dropout) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        const uint32_t kw[2] = {mm3_word(static_cast<uint32_t>(col)),
                                mm3_word(static_cast<uint32_t>(col + 1))};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= static_cast<uint32_t>(
                      keep_bit(qh[e >> 1], kw[e & 1], p.thresh))
                  << (j * 4 + e);
      }
    }
    cp_wait_prev();
    __syncthreads();
    const uint32_t ks = k_s + cur;

    // S = Q K^T and dP = dO V^T
    float s[kNt][4], dp[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<D, T>(q_s, ks, warp, lane, s);
    mm_abt<D, T>(do_s, v_s + cur, warp, lane, dp);

    // dS = P (dP keep / (1 - p) - delta), P = exp(scale S - lse) with a
    // masked score at -1e30 (1 in a fully masked row, whose lse is
    // -1e30); keys past sk contribute exactly nothing
    const bool edge =
        k0 + kTile > p.sk || (p.causal && q0 + off < k0 + kTile - 1);
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = fmaf(s[j][e], scale2, -lse2[i]);
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (col >= p.sk)
            x = -INFINITY;
          else if (p.causal && row0 + 8 * i + off < col)
            x = (kNegInf - lse[i]) * kLog2e;
        }
        const float dpv =
            (keep >> (j * 4 + e)) & 1u ? dp[j][e] * p.inv_keep : 0.f;
        s[j][e] = ex2(x) * (dpv - delta[i]);
      }
    // dQ += dS K (dS rounded to T; scaled at the end)
    mm_xb<D, T>(s, ks, lane, acc);
    __syncthreads();  // every warp is done with stage `cur` before refill
  }

  T* dq = const_cast<T*>(head<T>(p.o, p.st[kO], b, h));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= p.sq) continue;
    T* dqr = dq + row * p.st[kO][2] + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(dqr + c * 8) = pack2<T>(
          acc[c][2 * i] * p.scale, acc[c][2 * i + 1] * p.scale);
  }
}

// the keep mask itself, for checking the hash against the plain version
__global__ void keep_mask_kernel(uint8_t* out, int BH, int sq, int sk,
                                 uint32_t thresh, const long long* seed,
                                 int H, int b0, int h0, int Hg) {
  const long long n = static_cast<long long>(BH) * sq * sk;
  const uint32_t s = static_cast<uint32_t>(*seed);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int kk = static_cast<int>(i % sk);
    const long long r = i / sk;
    const int qq = static_cast<int>(r % sq);
    const int bh = static_cast<int>(r / sq);
    const int b = bh / H;
    const uint32_t gbh =
        static_cast<uint32_t>((b + b0) * Hg + h0 + (bh - b * H));
    const uint32_t hsh = mm3_final(mm3_round(
        mm3_round(mm3_round(s, gbh), static_cast<uint32_t>(qq)),
        static_cast<uint32_t>(kk)));
    out[i] = hsh < thresh ? 1 : 0;
  }
}

// the kernel, dynamic shared memory and block size of a pass
struct Kernel {
  void (*fn)(const Params);
  size_t bytes;
  int threads;
};

template <int D, typename T>
Kernel pick_tc(int pass) {
  if (pass == 0) return {fwd_kernel_mma<D, T>, fwd_mma_smem<D>(), kThreadsTc};
  if (pass == 1) return {dq_kernel_mma<D, T>, dq_mma_smem<D>(), kThreadsTc};
  return {dkv_kernel_mma<D, T>, dkv_mma_smem<D>(), kThreadsTc};
}

template <int D>
Kernel pick(int pass, int dtype) {
  // 16-bit operands: B1-B3 on the tensor cores
  if (dtype == 1) return pick_tc<D, bf16>(pass);
  if (dtype == 2) return pick_tc<D, f16>(pass);
  if (pass == 0) return {fwd_kernel<D>, fwd_smem<D>(), kThreads};
  if (pass == 1) return {dq_kernel<D>, dq_smem<D>(), kThreads};
  return {dkv_kernel<D>, dkv_smem<D>(), kThreads};
}

// pass 0-2, dtype 0 (f32), 1 (bf16) or 2 (f16), d 32 / 64 / 128; false
// otherwise
bool pick_for(int pass, int dtype, int d, Kernel* kern) {
  if (pass < 0 || pass > 2 || dtype < 0 || dtype > 2) return false;
  switch (d) {
    case 32: *kern = pick<32>(pass, dtype); return true;
    case 64: *kern = pick<64>(pass, dtype); return true;
    case 128: *kern = pick<128>(pass, dtype); return true;
    default: return false;
  }
}

}  // namespace

// pass: 0 forward (B1), 1 dq (B2), 2 dk/dv (B3); dtype: 0 f32, 1 bf16,
// 2 f16.
// `strides`: 18 host values, (batch, head, row) element strides of q,
// k, v, do, out, out2. Returns cudaGetLastError() of the launch.
extern "C" int flash_attn(int pass, int dtype, int d, const void* q,
                          const void* k, const void* v, const void* dout,
                          void* out, void* out2, float* lse,
                          const float* lse_in, const float* delta,
                          const long long* strides, int B, int H, int sq,
                          int sk, float scale, int causal, int dropout,
                          float inv_keep, unsigned thresh,
                          const long long* seed, int b0, int h0, int hg,
                          int num_sms, void* stream) {
  (void)num_sms;
  if (B * H > 65535) return cudaErrorInvalidValue;
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
  p.b0 = b0;
  p.h0 = h0;
  p.Hg = hg;
  Kernel kern;
  if (!pick_for(pass, dtype, d, &kern)) return cudaErrorInvalidValue;
  if (dtype != 0) {
    // the tensor-core kernels copy 16-byte row chunks of q, k, v, do and
    // store 16-bit pairs of the outputs
    const void* ins[4] = {q, k, v, pass != 0 ? dout : nullptr};
    for (int i = 0; i < 4; ++i) {
      if (ins[i] == nullptr) continue;
      if (reinterpret_cast<uintptr_t>(ins[i]) % 16 != 0)
        return cudaErrorInvalidValue;
      for (int j = 0; j < 3; ++j)
        if (p.st[i][j] % 8 != 0) return cudaErrorInvalidValue;
    }
    const void* outs[2] = {out, pass == 2 ? out2 : nullptr};
    for (int i = 0; i < 2; ++i)
      if (outs[i] != nullptr &&
          (reinterpret_cast<uintptr_t>(outs[i]) % 4 != 0 ||
           p.st[kO + i][2] % 2 != 0))
        return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kern.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((pass == 2 ? sk : sq) + kTile - 1) / kTile;
  kern.fn<<<dim3(tiles, B * H), kern.threads, kern.bytes,
            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// what flash_attn launches for (pass, dtype, d): registers and local
// (spilled) bytes a thread, threads and shared bytes a block, and the
// blocks an SM holds at once
extern "C" int flash_occupancy(int pass, int dtype, int d, int* out) {
  Kernel kern;
  if (!pick_for(pass, dtype, d, &kern)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kern.bytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], kern.fn, kern.threads, kern.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kern.threads;
  out[3] = static_cast<int>(kern.bytes);
  return 0;
}

extern "C" int flash_keep_mask(uint8_t* out, int BH, int sq, int sk,
                               unsigned thresh, const long long* seed,
                               int H, int b0, int h0, int hg,
                               int num_sms, void* stream) {
  keep_mask_kernel<<<num_sms * 4, 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      out, BH, sq, sk, thresh, seed, H, b0, h0, hg);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
