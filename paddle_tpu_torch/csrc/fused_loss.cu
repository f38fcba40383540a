// Fused LM-head loss for Hopper (sm_90a): cross entropy of x @ w^T
// without the [N, V] logits, forward and backward, on x [N, H] and the
// tied table w [V, H] (rows contiguous), labels int32 [N].
//
// Replaces the Pallas TPU kernels of paddle_tpu/ops/fused_loss.py:
//   B4 `_fwd_kernel`     -> forward:  per row lse = m + log(l) and
//                           nll = lse - s[label] from an online max /
//                           sum-exp / picked logit over vocab tiles
//   B5 `_bwd_dx_kernel`  -> dx = d @ w
//   B6 `_bwd_dw_kernel`  -> dw = d^T @ x
// where the backward rebuilds each score tile s = x w^T from lse and
// d = (softmax - onehot) * g, rounded to the operand dtype before both
// products (fused_loss.py:248,269,440). Columns >= vocab are masked
// (-1e30 in the forward, d = 0 in the backward); a label of -1 or
// ignore_index picks nothing (its nll is finite and discarded outside).
//
// Bound: at the ERNIE shape (N 16384, H 768, V 18000, bf16) B4 is one
// product, 453 GFLOP, and B5 / B6 two each (the scores again, then dx
// or dw), 906 GFLOP, against ~50 MB of operands: operations, not bytes.
//
// Design. One kernel shape serves all three: a block OWNS a tile of
// rows of one operand ("a": x for B4 / B5, w for B6), kept in shared
// memory for the whole block, and WALKS the other operand ("b": w for
// B4 / B5, x for B6) in tiles of kBQ = 64 rows. Each step loads the b
// tile, forms the score tile a b^T over all of H, then either folds it
// into the per-row online statistics (B4) or turns it into d and adds
// d b (B5: dx rows of the owned x rows) or d^T b (B6: dw rows of the
// owned vocab rows) into accumulators held in registers. The TPU
// kernels keep a [256, 768] dx and a [1024, 768] dw accumulator in VMEM
// (3 MB); here an owned tile is 32 rows, whose [32, H] f32 accumulator
// spreads over the block's 8 warps (96 registers a thread at H 768).
// B5 owns row tiles and walks the vocab, B6 owns vocab tiles and walks
// the rows, so every output element is summed by one thread in a fixed
// order: no atomics, results repeat bit for bit.
//
// bf16 operands run on the tensor cores with warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulators: the reference's
// arithmetic), fragments loaded with ldmatrix. The walked tile sits in
// shared memory as H / 64 chunk slots filled by cp.async; a slot is
// refilled with the next tile's chunk as soon as the block is done with
// it, so the loads of one step run under the products of the one
// before. The score tile stays in the accumulator registers for the
// epilogue; d is rounded to bf16 into shared memory and read back as
// the A operand of the second product, whose B operand (the walked
// tile, K = its rows) is transposed on load with ldmatrix.trans. f32
// operands (tests, steps without amp) take a CUDA-core path of the same
// shape in full f32 (no TF32). Shared-memory rows are padded by 16
// bytes, so fragment loads fall on distinct banks. H is a multiple of
// 64 up to 1024 (one instantiation each of 64, 128, 256, 512, 768,
// 1024); N and V are arbitrary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // rows of a walked tile (tensor-core path)
constexpr float kNegInf = -1e30f;  // the reference's mask fill (_NEG_INF)

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

struct Args {
  const void* a;      // owned operand [rows_a, H]: x (B4, B5) or w (B6)
  const void* b;      // walked operand [rows_b, H]: w (B4, B5) or x (B6)
  const int* labels;  // [N]
  const float* lse;   // [N], backward input
  const float* g;     // [N], backward input (upstream gradient of nll)
  float* nll;         // [N], forward output
  float* lse_out;     // [N], forward output
  void* out;          // dx [N, H] or dw [V, H], operand dtype
  int n, vocab;       // N, V
};

template <int MODE>
__device__ __forceinline__ int rows_a(const Args& p) {
  return MODE == kDw ? p.vocab : p.n;
}
template <int MODE>
__device__ __forceinline__ int rows_b(const Args& p) {
  return MODE == kDw ? p.n : p.vocab;
}

// d of one score: (exp(s - lse) - onehot) * g on a valid (token, vocab)
// pair, 0 elsewhere (padding rows, vocab tail)
__device__ __forceinline__ float dlogit(float s, bool ok, float lse, float g,
                                        bool hit) {
  return ok ? (expf(s - lse) - (hit ? 1.f : 0.f)) * g : 0.f;
}

template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The CUDA-core forward's online statistics of one owned row, kept by the TPR
// consecutive threads that share it (each holds the reduced m and l
// and its own partial of the picked logit).
template <int BP, int BQ>
struct RowStats {
  static constexpr int TPR = kThreads / BP;
  static constexpr int CPT = BQ / TPR;
  float m = kNegInf, l = 0.f, picked = 0.f;

  // fold the f32 score tile Sf [BP][ld] of vocab rows v0.. into the
  // statistics of row threadIdx.x / TPR
  __device__ __forceinline__ void update(const float* Sf, int ld, int v0,
                                         int vocab, int label) {
    const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
    float s[CPT];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = c * TPR + sub;
      const int v = v0 + col;
      float x = v < vocab ? Sf[r * ld + col] : kNegInf;
      if (v < vocab && v == label) picked += x;
      s[c] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, group_max<TPR>(mx));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) sum += expf(s[c] - m_new);
    l = l * expf(m - m_new) + group_sum<TPR>(sum);
    m = m_new;
  }

  // every row has >= 1 valid column, so l >= 1 after the running max
  __device__ __forceinline__ void finish(const Args& p, int row0) {
    const int r = threadIdx.x / TPR, sub = threadIdx.x % TPR;
    const float pk = group_sum<TPR>(picked);
    const int t = row0 + r;
    if (sub == 0 && t < p.n) {
      const float lse = m + logf(l);
      p.lse_out[t] = lse;
      p.nll[t] = lse - pk;
    }
  }
};

// copy `rows` rows of H elements from global row row0 on (zeros past
// `limit`) into shared memory with a row stride of `ld` elements, in
// 16-byte vectors
template <typename T, int H>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int row0, int rows, int limit) {
  constexpr int kVec = H * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * H) +
                c);
    reinterpret_cast<uint4*>(dst + (size_t)r * ld)[c] = v;
  }
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

__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// wait until at most `n` (< 16) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

constexpr int kKC = 64;          // H columns of a walked-tile chunk
constexpr int kLDC = kKC + 8;    // its row stride (bf16): 144 bytes

template <int BP, int H>
constexpr size_t tc_smem_bytes(int mode) {
  return (size_t)BP * (H + 8) * 2 + (size_t)(H / kKC) * kBQ * kLDC * 2 +
         (mode == kFwd ? (size_t)kWarps * BP * 3 * 4
                       : (size_t)BP * (kBQ + 8) * 2);
}

// Copy H-chunk `c` of the walked tile's rows b0.. (zeros past nb) into
// its slot, as one commit group. Always commits, copying nothing past
// the last tile, so every thread counts the same groups.
template <int H>
__device__ __forceinline__ void fetch_chunk(__nv_bfloat16* Bs,
                                            const __nv_bfloat16* b, int b0,
                                            int nb, int c) {
  __nv_bfloat16* slot = Bs + c * kBQ * kLDC;
  for (int i = threadIdx.x; i < kBQ * (kKC / 8); i += kThreads) {
    const int r = i / (kKC / 8), v = i % (kKC / 8);
    const bool ok = b0 + r < nb;
    const __nv_bfloat16* src =
        b + (ok ? (size_t)(b0 + r) * H + c * kKC + v * 8 : 0);
    cp_async16(slot + r * kLDC + v * 8, src, ok);
  }
  cp_async_commit();
}

// BP owned rows (32 or 64), H a multiple of 64. The walked tile lives
// in shared memory as NC = H / 64 chunk slots of [kBQ, 64]; a slot is
// refilled with the next tile's chunk as soon as every warp is done
// with it (B4: after the score product reads it; B5 / B6: after the
// second product does), so the loads of tile i+1 run under the
// products of tile i. Warps split the score tile [BP, kBQ] into WM x WN
// tiles of 16 x (kBQ / WN); in the second product warp w owns columns
// [64 c + 8 w, 64 c + 8 w + 8) of every chunk c of the [BP, H]
// accumulator.
template <int MODE, int BP, int H>
__global__ void __launch_bounds__(kThreads, 1) tc_kernel(const Args p) {
  constexpr int LDA = H + 8;          // owned-tile row stride (bf16)
  constexpr int NC = H / kKC;         // chunks of the walked tile
  constexpr int WM = BP / 16, WN = kWarps / WM;
  constexpr int NJ = kBQ / WN / 8;    // n8 tiles of a warp's score tile
  constexpr int MI = BP / 16;         // m16 tiles of the accumulator
  constexpr int LDD = kBQ + 8;        // d tile row stride (bf16)
  static_assert(NJ % 2 == 0, "score tiles pair n8 tiles");

  extern __shared__ uint4 smem4[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Bs = As + BP * LDA;
  void* tail = Bs + NC * kBQ * kLDC;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp % WM) * 16, q0 = (warp / WM) * (kBQ / WN);
  const int a0 = blockIdx.x * BP;
  const int na = rows_a<MODE>(p), nb = rows_b<MODE>(p);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);

  // the owned tile (one group), then every chunk of the first walked tile
  for (int i = threadIdx.x; i < BP * (H / 8); i += kThreads) {
    const int r = i / (H / 8), v = i % (H / 8);
    const bool ok = a0 + r < na;
    cp_async16(As + r * LDA + v * 8, A + (ok ? (size_t)(a0 + r) * H + v * 8
                                             : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < NC; ++c) fetch_chunk<H>(Bs, B, 0, nb, c);

  // per-token operands of the thread's two owned rows (B4, B5: rows
  // are tokens)
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  int lab_r[2] = {-1, -1};
  if (MODE != kDw) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = a0 + m0 + g + 8 * h;
      if (t < p.n) {
        lab_r[h] = p.labels[t];
        if (MODE == kDx) {
          lse_r[h] = p.lse[t];
          g_r[h] = p.g[t];
        }
      }
    }
  }
  // B4: the online max / sum-exp / picked logit of those rows over the
  // warp's columns, kept in registers (the 4 lanes of a quad hold the
  // same m and l); the WN warps of a row combine once at the end
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f},
        pk_r[2] = {0.f, 0.f};

  float acc[MI][NC][4];
  if constexpr (MODE != kFwd) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][c][e] = 0.f;
  }

  for (int b0 = 0; b0 < nb; b0 += kBQ) {
    const int b1 = b0 + kBQ;          // the next walked tile
    // B6: per-token operands of this tile's columns, loaded under the
    // score product
    float lse_c[NJ][2], g_c[NJ][2];
    int lab_c[NJ][2];
    if constexpr (MODE == kDw) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = b0 + q0 + j * 8 + 2 * t4 + e;
          const bool ok = t < p.n;
          lse_c[j][e] = ok ? p.lse[t] : 0.f;
          g_c[j][e] = ok ? p.g[t] : 0.f;
          lab_c[j][e] = ok ? p.labels[t] : -1;
        }
    }

    // scores of the warp's 16 x (8 NJ) tile, f32 accumulation over H
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int c = 0; c < NC; ++c) {
      // in flight past chunk c: this tile's later chunks, plus (B4) the
      // next tile's chunks 0 .. c-2
      cp_async_wait_n(MODE == kFwd && c > 0 ? NC - 2 : NC - 1 - c);
      __syncthreads();  // chunk c visible; every warp is done with c - 1
      if (MODE == kFwd && c > 0) fetch_chunk<H>(Bs, B, b1, nb, c - 1);
      const __nv_bfloat16* slot = Bs + c * kBQ * kLDC;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t a[4];
        ldsm_x4(a, As + (m0 + (lane & 15)) * LDA + c * kKC + kk +
                       (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t b[4];
          ldsm_x4(b, slot + (q0 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                                kLDC +
                         kk + ((lane >> 3) & 1) * 8);
          mma_bf16(s[j], a, b);
          mma_bf16(s[j + 1], a, b + 2);
        }
      }
    }

    if constexpr (MODE == kFwd) {
      __syncthreads();  // every warp is done with the last chunk
      fetch_chunk<H>(Bs, B, b1, nb, NC - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[NJ][2];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = b0 + q0 + j * 8 + 2 * t4 + e;
            const float sv = s[j][2 * h + e];
            if (v < p.vocab && v == lab_r[h]) pk_r[h] += sv;
            x[j][e] = v < p.vocab ? sv : kNegInf;
            mx = fmaxf(mx, x[j][e]);
          }
        const float m_new = fmaxf(m_r[h], group_max<4>(mx));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sum += expf(x[j][0] - m_new) + expf(x[j][1] - m_new);
        l_r[h] = l_r[h] * expf(m_r[h] - m_new) + group_sum<4>(sum);
        m_r[h] = m_new;
      }
    } else {
      // d of the tile, rounded to bf16, into shared memory
      __nv_bfloat16* Ds = static_cast<__nv_bfloat16*>(tail);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = q0 + j * 8 + 2 * t4 + e;
            const float sv = s[j][2 * h + e];
            if (MODE == kDx) {
              const int t = a0 + r, v = b0 + q;
              d[e] = dlogit(sv, t < p.n && v < p.vocab, lse_r[h], g_r[h],
                            v == lab_r[h]);
            } else {
              const int v = a0 + r, t = b0 + q;
              d[e] = dlogit(sv, t < p.n && v < p.vocab, lse_c[j][e],
                            g_c[j][e], v == lab_c[j][e]);
            }
          }
          *reinterpret_cast<uint32_t*>(Ds + r * LDD + q0 + j * 8 + 2 * t4) =
              pack_bf16(d[0], d[1]);
        }
      }
      __syncthreads();

      // acc[BP, warp's columns] += d [BP, kBQ] @ walked tile [kBQ, H]
      uint32_t ad[MI][kBQ / 16][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ks = 0; ks < kBQ / 16; ++ks)
          ldsm_x4(ad[mi][ks], Ds + (mi * 16 + (lane & 15)) * LDD + ks * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const __nv_bfloat16* slot = Bs + c * kBQ * kLDC;
#pragma unroll
        for (int ks = 0; ks < kBQ / 16; ++ks) {
          uint32_t b[2];
          ldsm_x2_trans(b, slot + (ks * 16 + (lane & 15)) * kLDC + warp * 8);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][c], ad[mi][ks], b);
        }
        __syncthreads();  // every warp is done with chunk c
        fetch_chunk<H>(Bs, B, b1, nb, c);
      }
    }
  }

  if constexpr (MODE == kFwd) {
    // combine the WN column slices of each row: lse = M + log(sum_i
    // l_i exp(m_i - M)), nll = lse - picked (l >= 1 overall: every row
    // has a valid column)
    float* part = static_cast<float*>(tail);   // [WN][BP][3]
    const int wn = warp / WM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float pk = group_sum<4>(pk_r[h]);
      if (t4 == 0) {
        float* q = part + (wn * BP + m0 + g + 8 * h) * 3;
        q[0] = m_r[h];
        q[1] = l_r[h];
        q[2] = pk;
      }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < BP; r += kThreads) {
      const int t = a0 + r;
      if (t >= p.n) continue;
      float M = kNegInf;
#pragma unroll
      for (int i = 0; i < WN; ++i) M = fmaxf(M, part[(i * BP + r) * 3]);
      float L = 0.f, P = 0.f;
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const float* q = part + (i * BP + r) * 3;
        L += q[1] * expf(q[0] - M);
        P += q[2];
      }
      const float lse = M + logf(L);
      p.lse_out[t] = lse;
      p.nll[t] = lse - P;
    }
    return;
  }
  cp_async_wait<0>();   // the empty groups past the last tile
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = a0 + mi * 16 + g + 8 * h;
      if (row >= na) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * H + c * kKC +
                                     warp * 8 + 2 * t4) =
            pack_bf16(acc[mi][c][2 * h], acc[mi][c][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32 operands, full f32)
// ---------------------------------------------------------------------------

constexpr int kFP = 16;   // owned rows
constexpr int kFQ = 32;   // walked rows per step

template <int H>
constexpr size_t f32_smem_bytes() {
  return (size_t)(kFP + kFQ) * (H + 4) * 4 + (size_t)kFP * (kFQ + 1) * 4;
}

// Each thread forms 2 scores (row tid / 16, columns tid % 16 and +16)
// with float4 reads along H, and owns kFP * H / 256 elements of the
// [kFP, H] accumulator (element tid + 256 i).
template <int MODE, int H>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Args p) {
  constexpr int LDA = H + 4;
  constexpr int LDS = kFQ + 1;
  constexpr int NACC = kFP * H / kThreads;

  extern __shared__ uint4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kFP * LDA;
  float* Ss = Bs + kFQ * LDA;

  const int a0 = blockIdx.x * kFP;
  const int na = rows_a<MODE>(p), nb = rows_b<MODE>(p);
  load_rows<float, H>(As, LDA, static_cast<const float*>(p.a), a0, kFP, na);

  const int r = threadIdx.x / 16, c0 = threadIdx.x % 16;
  float lse_r = 0.f, g_r = 0.f;
  int lab_r = -1;
  if (MODE == kDx && a0 + r < p.n) {
    lse_r = p.lse[a0 + r];
    g_r = p.g[a0 + r];
    lab_r = p.labels[a0 + r];
  }
  RowStats<kFP, kFQ> stats;
  int label_f = -1;
  if (MODE == kFwd) {
    const int t = a0 + threadIdx.x / RowStats<kFP, kFQ>::TPR;
    if (t < p.n) label_f = p.labels[t];
  }
  float acc[NACC];
  if constexpr (MODE != kFwd) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  }

  for (int b0 = 0; b0 < nb; b0 += kFQ) {
    __syncthreads();
    load_rows<float, H>(Bs, LDA, static_cast<const float*>(p.b), b0, kFQ,
                        nb);
    __syncthreads();
    float s[2] = {0.f, 0.f};
    const float4* ar = reinterpret_cast<const float4*>(As + r * LDA);
    const float4* br0 = reinterpret_cast<const float4*>(Bs + c0 * LDA);
    const float4* br1 = reinterpret_cast<const float4*>(Bs + (c0 + 16) * LDA);
#pragma unroll 4
    for (int k = 0; k < H / 4; ++k) {
      const float4 av = ar[k], b0v = br0[k], b1v = br1[k];
      s[0] = fmaf(av.x, b0v.x, s[0]);
      s[0] = fmaf(av.y, b0v.y, s[0]);
      s[0] = fmaf(av.z, b0v.z, s[0]);
      s[0] = fmaf(av.w, b0v.w, s[0]);
      s[1] = fmaf(av.x, b1v.x, s[1]);
      s[1] = fmaf(av.y, b1v.y, s[1]);
      s[1] = fmaf(av.z, b1v.z, s[1]);
      s[1] = fmaf(av.w, b1v.w, s[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + 16 * e;
      float val = s[e];
      if (MODE == kDx) {
        const int t = a0 + r, v = b0 + c;
        val = dlogit(s[e], t < p.n && v < p.vocab, lse_r, g_r, v == lab_r);
      } else if (MODE == kDw) {
        const int v = a0 + r, t = b0 + c;
        val = (t < p.n && v < p.vocab)
                  ? dlogit(s[e], true, p.lse[t], p.g[t], v == p.labels[t])
                  : 0.f;
      }
      Ss[r * LDS + c] = val;
    }
    __syncthreads();
    if constexpr (MODE == kFwd) {
      stats.update(Ss, LDS, b0, p.vocab, label_f);
    } else {
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int row = e / H, col = e % H;
        float sum = acc[i];
#pragma unroll 8
        for (int q = 0; q < kFQ; ++q)
          sum = fmaf(Ss[row * LDS + q], Bs[q * LDA + col], sum);
        acc[i] = sum;
      }
    }
  }

  if constexpr (MODE == kFwd) {
    stats.finish(p, a0);
    return;
  }
  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int row = a0 + e / H, col = e % H;
    if (row < na) out[(size_t)row * H + col] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch_one(K kernel, size_t smem, int rows, int per_block,
                       const Args& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (rows + per_block - 1) / per_block;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_h(int mode, int bf16, const Args& p, cudaStream_t st) {
  const int rows = mode == kDw ? p.vocab : p.n;
  if (!bf16) {
    const size_t smem = f32_smem_bytes<H>();
    switch (mode) {
      case kFwd: return launch_one(f32_kernel<kFwd, H>, smem, rows, kFP, p, st);
      case kDx: return launch_one(f32_kernel<kDx, H>, smem, rows, kFP, p, st);
      default: return launch_one(f32_kernel<kDw, H>, smem, rows, kFP, p, st);
    }
  }
  // the forward owns 64 rows (half the walks over w) where they fit
  constexpr int kFwdBP = H <= 768 ? 64 : 32;
  switch (mode) {
    case kFwd:
      return launch_one(tc_kernel<kFwd, kFwdBP, H>,
                        tc_smem_bytes<kFwdBP, H>(kFwd), rows, kFwdBP, p, st);
    case kDx:
      return launch_one(tc_kernel<kDx, 32, H>, tc_smem_bytes<32, H>(kDx),
                        rows, 32, p, st);
    default:
      return launch_one(tc_kernel<kDw, 32, H>, tc_smem_bytes<32, H>(kDw),
                        rows, 32, p, st);
  }
}

}  // namespace

// mode: 0 forward (B4: nll, lse), 1 dx (B5), 2 dw (B6); dtype: 0 f32,
// 1 bf16 (x and w share it). x [n, H], w [vocab, H], out [n or vocab,
// H], all rows contiguous and 16-byte aligned; labels int32 [n]; lse,
// g f32 [n]. Returns cudaGetLastError() of the launch.
extern "C" int fused_lce(int mode, int dtype, int H, const void* x,
                         const void* w, const int* labels, const float* lse,
                         const float* g, float* nll, float* lse_out, void* out,
                         int n, int vocab, int num_sms, void* stream) {
  (void)num_sms;
  if (mode < 0 || mode > 2 || n <= 0 || vocab <= 0)
    return cudaErrorInvalidValue;
  Args p;
  p.a = mode == kDw ? w : x;
  p.b = mode == kDw ? x : w;
  p.labels = labels;
  p.lse = lse;
  p.g = g;
  p.nll = nll;
  p.lse_out = lse_out;
  p.out = out;
  p.n = n;
  p.vocab = vocab;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (H) {
    case 64: err = launch_h<64>(mode, dtype, p, st); break;
    case 128: err = launch_h<128>(mode, dtype, p, st); break;
    case 256: err = launch_h<256>(mode, dtype, p, st); break;
    case 512: err = launch_h<512>(mode, dtype, p, st); break;
    case 768: err = launch_h<768>(mode, dtype, p, st); break;
    case 1024: err = launch_h<1024>(mode, dtype, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
