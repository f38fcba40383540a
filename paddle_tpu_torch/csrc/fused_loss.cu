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
// B4 / B5, x for B6) in tiles of 64 rows. Each step loads the b tile,
// forms the score tile a b^T over all of H, then either folds it into
// the per-row online statistics (B4) or turns it into d and adds d b
// (B5: dx rows of the owned x rows) or d^T b (B6: dw rows of the owned
// vocab rows) into f32 accumulators held in registers. The TPU kernels
// keep a [256, 768] dx and a [1024, 768] dw accumulator in VMEM (3 MB);
// here the register file (256 KB an SM) holds them. B5 owns row tiles
// and walks the vocab, B6 owns vocab tiles and walks the rows, so every
// output element is summed by one thread in a fixed order: no atomics,
// results repeat bit for bit. Columns past V and rows past N are
// zero-filled by the copies and masked in d.
//
// B4 in bf16 (tc_kernel): warp-level mma.sync.m16n8k16 (bf16 in, f32
// accumulators: the reference's arithmetic), fragments loaded with
// ldmatrix. An owned tile is 64 rows up to H 768 (32 at H 1024); the
// walked tile sits in shared memory as H / 64 chunk slots filled by
// cp.async; a slot is refilled with the next tile's chunk as soon as the
// block is done with it, so the loads of one step run under the
// products of the one before. At H 1024 B5 and B6 run the same kernel
// with 32 owned rows, their [32, 1024] f32 accumulator spread over 8
// warps: d is rounded to bf16 into shared memory and read back as the A
// operand of the second product, whose B operand (the walked tile, K =
// its rows) is transposed on load with ldmatrix.trans. Shared-memory
// rows are padded by 16 bytes, so fragment loads fall on distinct banks.
//
// B5 and B6 in bf16 (wg_kernel, H <= 768): warpgroup products (wgmma)
// with both operands read from shared memory through descriptors, so no
// fragment passes through registers. B5 owns token rows and walks the
// vocab, B6 owns vocab rows and walks the tokens; the rest is one code
// path. Against the 32-row mma.sync design it replaced (B6 6.4 ms, B5
// 5.7 ms at the ERNIE shape on an H100): a block owns 64 rows, so the
// walked operand streams through L2 half as often (B5: the 27.6 MB
// table 256 times instead of 512; B6: x 282 times instead of 563); the
// score product is m64n32 a warpgroup and the second product m64n64,
// against 16 x 16 warp tiles fed by two ldmatrix a pair of mma; the
// [64, 768] f32 accumulator (192 KB) spreads over two warpgroups at 192
// registers a thread (no spills); the next walked tile is refilled part
// by part under the current tile's products; B6's tail vocab tiles split
// over the tokens (dw_split; B5's waves need no split, see wg_kernel).
// What bounds it now: one block an SM (202 KB of shared memory), whose
// phases (score product, d on the CUDA cores, second product, the next
// tile's first loads) follow each other. At H 1024 the 64-row
// accumulator would fill the register file, so B5 and B6 keep the
// 32-row mma.sync kernel there.
//
// f32 operands (tests, steps without amp) take a CUDA-core path of the
// same shape in full f32 (no TF32). H is a multiple of 64 up to 1024
// (one instantiation each of 64, 128, 256, 512, 768, 1024); N and V are
// arbitrary.

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
  // B6 on warpgroup products: vocab tiles >= `full` are split over the
  // tokens into `pieces` ranges of `piece_tokens`; each piece writes its
  // f32 partial [64, H] to `ws` and counts itself in `count` (one int a
  // split tile, zeroed before the launch)
  float* ws;
  int* count;
  int full, pieces, piece_tokens;
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
// B5 and B6 in bf16 on warpgroup products (wgmma), H <= 768
// ---------------------------------------------------------------------------
// One kernel, two roles. A block of two warpgroups owns 64 rows of one
// operand (the wgmma M: 64 tokens of x for B5, 64 vocab rows of w for
// B6) and walks the other in tiles of 64 rows. Per walked tile:
//   S [64 owned, 64 walked] = A B^T over H: warpgroup g forms the
//     m64n32 half of walked rows 32 g .. 32 g + 31 (both operands
//     K-major in shared memory), one k16 step per wgmma;
//   d = (exp(S - lse) - onehot) * g, rounded to bf16 into D [64, 64]
//     (B5: lse, g and the label of the owned token rows, in registers
//     for the whole walk; B6: those of the walked tile's tokens, copied
//     in with the tile);
//   out [64, H] += D B: warpgroup g owns the H / 2 columns of every
//     other 64-column chunk (chunks g, g + 2, ...), m64n64 accumulators
//     in f32 registers (H 768: 192 a thread, two warpgroups of 128
//     threads, one block an SM), B read MN-major by the same
//     descriptors' transpose bit.
// Shared memory holds the owned rows A [64, H] and the walked tile
// B [64, H] as 64-column chunks of [64 rows][128 bytes] with the 128-byte
// swizzle (16-byte unit u of row r at u ^ (r % 8)), D [64, 64] likewise.
// The tile's columns are refilled part by part (a part: one warpgroup's
// chunk) by cp.async as soon as that warpgroup's second product on them
// has finished, so the next tile's loads run under this tile's products
// and the next score product starts on the parts that landed first.
//
// Waves. B5 owns 16384 / 64 = 256 token tiles at the ERNIE shape: on 132
// SMs, one block an SM, that is one full wave and a second 94 % full, so
// it launches the tiles as they are. B6 owns 282 vocab tiles: two full
// waves and a third of 18 blocks (14 %), so the tiles past the last full
// wave split over the tokens (dw_split).
constexpr int kWgThreads = 256;     // two warpgroups
constexpr int kVP = 64;             // owned vocab rows
constexpr int kTQ = 64;             // tokens a walked tile
constexpr uint32_t kChunk = 64 * 128;   // bytes of a swizzled chunk

template <int H>
constexpr size_t wg_smem() {
  // alignment slack, A and B chunks, D, the walked tile's lse / g /
  // labels (B6)
  return 1024 + 2 * (size_t)(H / 64) * kChunk + kChunk + 3 * kTQ * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src,
                                             bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4_s(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

// byte offset of 16-byte unit u (0..7) of row r inside a swizzled chunk
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * 128 + ((u ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (K-major: the stride steps 8 rows of
// M or N, the leading offset is unused; MN-major: the stride steps 8
// rows of K, the leading offset 64 columns of M or N)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// wait until at most `n` (< 8) of the warpgroup's product groups run
__device__ __forceinline__ void wg_wait_n(int n) {
  switch (n) {
    case 0: wg_wait<0>(); break;
    case 1: wg_wait<1>(); break;
    case 2: wg_wait<2>(); break;
    case 3: wg_wait<3>(); break;
    case 4: wg_wait<4>(); break;
    case 5: wg_wait<5>(); break;
    case 6: wg_wait<6>(); break;
    default: wg_wait<7>(); break;
  }
}
// generic-proxy writes (st.shared, cp.async) made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products that own the registers
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] (+)= A B, bf16 from shared memory through descriptors; the
// f32 accumulator of lane (g, t) of warp w: d[4 j + 2 h + e] is row
// 16 w + g + 8 h, column 8 j + 2 t + e
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B));
}

// PW columns a part (one wgmma n: 64, or 32 at H = 64, where the two
// warpgroups split the only chunk), NP parts a warpgroup
template <int MODE, int H>
__global__ void __launch_bounds__(kWgThreads, 1) wg_kernel(const Args p) {
  constexpr int NC = H / 64;
  constexpr int PW = H >= 128 ? 64 : 32;
  constexpr int NP = H / 2 / PW;
  constexpr int R = PW / 2;           // accumulator registers of a part
  static_assert(NP >= 1 && NP <= 8, "parts a warpgroup");
  static_assert(MODE == kDx || MODE == kDw, "backward modes");

  extern __shared__ uint4 smem4[];
  const uint32_t raw = smem_u32(smem4);
  const uint32_t a_s = (raw + 1023) & ~1023u;   // swizzle atoms: 1 KB
  const uint32_t b_s = a_s + NC * kChunk;
  const uint32_t d_s = b_s + NC * kChunk;
  const uint32_t rows_s = d_s + kChunk;         // lse, g, labels [kTQ]
  const char* rows_p = reinterpret_cast<const char*>(smem4) + (rows_s - raw);
  const float* lse_t = reinterpret_cast<const float*>(rows_p);
  const float* g_t = lse_t + kTQ;
  const int* lab_t = reinterpret_cast<const int*>(g_t + kTQ);

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // the block's owned tile and walked range [t_lo, t_hi)
  int vt = blockIdx.x, piece = -1, t_lo = 0, t_hi = rows_b<MODE>(p);
  if (vt >= p.full) {
    const int b = vt - p.full;
    vt = p.full + b / p.pieces;
    piece = b % p.pieces;
    t_lo = piece * p.piece_tokens;
    t_hi = min(t_hi, t_lo + p.piece_tokens);
  }
  const int a0 = vt * kVP;
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b);
  auto part_col = [&](int pp) {
    return PW == 64 ? (2 * pp + wg) * 64 : wg * 32;
  };

  // the owned rows, one commit group of every thread
  for (int i = tid; i < kVP * (H / 8); i += kWgThreads) {
    const int r = i / (H / 8), u = i % (H / 8);
    const bool ok = a0 + r < rows_a<MODE>(p);
    cp_async16_s(a_s + (u >> 3) * kChunk + swz(r, u & 7),
                 A + (ok ? (size_t)(a0 + r) * H + u * 8 : 0), ok);
  }
  cp_async_commit();
  // part pp of the walked tile of rows t0..: this warpgroup's columns
  // (zeros past t_hi) and, with part 0 of B6, the tile's lse, g and
  // labels; one commit group of every thread, whatever it copies
  auto fill = [&](int t0, int pp) {
    const int col0 = part_col(pp);
    for (int i = wt; i < kTQ * (PW / 8); i += 128) {
      const int r = i / (PW / 8), col = col0 + (i % (PW / 8)) * 8;
      const bool ok = t0 + r < t_hi;
      cp_async16_s(b_s + (col >> 6) * kChunk + swz(r, (col & 63) >> 3),
                   B + (ok ? (size_t)(t0 + r) * H + col : 0), ok);
    }
    if (MODE == kDw && pp == 0 && wt < kTQ) {
      const int t = t0 + wt;
      const bool ok = t < t_hi;
      const int at = ok ? t : 0;
      if (wg == 0) {
        cp_async4_s(rows_s + wt * 4, p.lse + at, ok);
        cp_async4_s(rows_s + (kTQ + wt) * 4, p.g + at, ok);
      } else {
        cp_async4_s(rows_s + (2 * kTQ + wt) * 4, p.labels + at, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) fill(t_lo, pp);

  // B5: lse, g and the label of the thread's two owned token rows
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  int lab_r[2] = {-1, -1};
  if constexpr (MODE == kDx) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = a0 + warp * 16 + g + 8 * h;
      if (t < p.n) {
        lse_r[h] = p.lse[t];
        g_r[h] = p.g[t];
        lab_r[h] = p.labels[t];
      }
    }
  }

  float acc[NP][R];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int e = 0; e < R; ++e) acc[pp][e] = 0.f;

  for (int t0 = t_lo; t0 < t_hi; t0 += kTQ) {
    // S: warpgroup wg's 32 walked rows, over the chunks as their parts
    // land
    float s[16];
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      cp_async_wait_n(NP - 1 - pp);
      fence_async_smem();
      __syncthreads();        // parts pp of both warpgroups have landed
      wg_fence();
#pragma unroll
      for (int c = 2 * pp; c < (2 * pp + 2 < NC ? 2 * pp + 2 : NC); ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_n32<0>(s, wg_desc(a_s + c * kChunk + kk * 32, 16, 1024),
                       wg_desc(b_s + c * kChunk + wg * 32 * 128 + kk * 32,
                               16, 1024),
                       (c | kk) != 0);
      wg_commit();
    }
    wg_wait<0>();
    reg_fence(s);

    // d of the tile, rounded to bf16, into D [owned row][walked row]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        const int tl = wg * 32 + j * 8 + 2 * t4;   // the tile's walked row
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[4 * j + 2 * h + e];
          const bool ok = t0 + tl + e < t_hi && a0 + r < rows_a<MODE>(p);
          if constexpr (MODE == kDx)   // owned tokens, walked vocab
            d[e] = dlogit(sv, ok, lse_r[h], g_r[h], t0 + tl + e == lab_r[h]);
          else                         // owned vocab, walked tokens
            d[e] = dlogit(sv, ok, lse_t[tl + e], g_t[tl + e],
                          a0 + r == lab_t[tl + e]);
        }
        const uint32_t dst = d_s + swz(r, tl >> 3) + (tl & 7) * 2;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                     "r"(pack_bf16(d[0], d[1])));
      }
    fence_async_smem();
    __syncthreads();          // D complete; every S product is done

    // out[:, part] += D B[:, part], one commit group a part
    wg_fence();
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      const int col0 = part_col(pp);
      const uint32_t bb = b_s + (col0 >> 6) * kChunk + (col0 & 63) * 2;
#pragma unroll
      for (int kk = 0; kk < kTQ / 16; ++kk) {
        const uint64_t da = wg_desc(d_s + kk * 32, 16, 1024);
        // one 64-column atom in N: the leading offset (the next atom's)
        // is never stepped, so it is given the stride of 8 K rows too
        const uint64_t db = wg_desc(bb + kk * 16 * 128, 1024, 1024);
        if constexpr (PW == 64)
          wgmma_n64<1>(acc[pp], da, db, 1);
        else
          wgmma_n32<1>(acc[pp], da, db, 1);
      }
      wg_commit();
    }
    // refill each part for the next tile once its products are done
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      wg_wait_n(NP - 1 - pp);
      fill(t0 + kTQ, pp);
    }
  }
  cp_async_wait<0>();       // the copies past the last tile
#pragma unroll
  for (int pp = 0; pp < NP; ++pp) reg_fence(acc[pp]);

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  if (piece < 0) {
#pragma unroll
    for (int pp = 0; pp < NP; ++pp)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = a0 + warp * 16 + g + 8 * h;
        if (row >= rows_a<MODE>(p)) continue;
#pragma unroll
        for (int j = 0; j < R / 4; ++j)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * H +
                                       part_col(pp) + j * 8 + 2 * t4) =
              pack_bf16(acc[pp][4 * j + 2 * h], acc[pp][4 * j + 2 * h + 1]);
      }
    return;
  }

  // a piece of a split tile (B6): its f32 partial into the workspace;
  // the piece that finishes last sums all of them in piece order (the
  // same order whichever block it is, so results repeat bit for bit)
  float* part = p.ws + (size_t)(blockIdx.x - p.full) * kVP * H;
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < R / 4; ++j)
        *reinterpret_cast<float2*>(part + (warp * 16 + g + 8 * h) * H +
                                   part_col(pp) + j * 8 + 2 * t4) =
            make_float2(acc[pp][4 * j + 2 * h], acc[pp][4 * j + 2 * h + 1]);
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem4);   // the copies are all done
  if (tid == 0)
    *last = atomicAdd(p.count + (vt - p.full), 1) == p.pieces - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float2* parts = reinterpret_cast<const float2*>(
      p.ws + (size_t)(vt - p.full) * p.pieces * kVP * H);
  for (int i = tid; i < kVP * H / 2; i += kWgThreads) {
    const int row = a0 + 2 * i / H;
    if (row >= rows_a<MODE>(p)) break;
    float2 sum = __ldcg(parts + i);
    for (int q = 1; q < p.pieces; ++q) {
      const float2 x = __ldcg(parts + (size_t)q * kVP * H / 2 + i);
      sum.x += x.x;
      sum.y += x.y;
    }
    *reinterpret_cast<uint32_t*>(out + (size_t)a0 * H + 2 * i) =
        pack_bf16(sum.x, sum.y);
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

// the kernel, dynamic shared memory, block size and owned rows a block
// of a mode
struct Kernel {
  void (*fn)(const Args);
  size_t bytes;
  int threads, rows;
  bool split = false;   // B6 on warpgroup products: see dw_split
};

// B6's grid on `sms` SMs: the vocab tiles past the last whole wave are
// each split over the tokens into `pieces` ranges of `tiles` token
// tiles, so the last wave holds about as many blocks as the others
// (ERNIE: 282 tiles on 132 SMs, 264 whole and 18 split 7 ways)
struct Split {
  int full, pieces, tiles, split_tiles;
};
Split dw_split(int n, int vocab, int sms) {
  const int nvt = (vocab + kVP - 1) / kVP, ntt = (n + kTQ - 1) / kTQ;
  const int rem = nvt % sms;
  if (rem == 0 || sms / rem < 2 || ntt < 2) return {nvt, 1, ntt, 0};
  int pieces = min(sms / rem, ntt);
  const int tiles = (ntt + pieces - 1) / pieces;
  pieces = (ntt + tiles - 1) / tiles;   // none empty
  return {nvt - rem, pieces, tiles, rem};
}

// workspace of a split launch: the pieces' f32 partials, then a counter
// a split tile
size_t dw_ws_bytes(const Split& sp, int H) {
  return (size_t)sp.split_tiles * sp.pieces * kVP * H * 4 +
         (size_t)sp.split_tiles * 4;
}

template <int H>
Kernel pick_h(int mode, int bf16) {
  if (!bf16) {
    const size_t smem = f32_smem_bytes<H>();
    switch (mode) {
      case kFwd: return {f32_kernel<kFwd, H>, smem, kThreads, kFP};
      case kDx: return {f32_kernel<kDx, H>, smem, kThreads, kFP};
      default: return {f32_kernel<kDw, H>, smem, kThreads, kFP};
    }
  }
  // the forward owns 64 rows (half the walks over w) where they fit
  constexpr int kFwdBP = H <= 768 ? 64 : 32;
  if (mode == kFwd)
    return {tc_kernel<kFwd, kFwdBP, H>, tc_smem_bytes<kFwdBP, H>(kFwd),
            kThreads, kFwdBP};
  // a 64-row f32 accumulator of 1024 columns would fill the register
  // file: H 1024 keeps the 32-row mma.sync kernel for B5 and B6
  if constexpr (H <= 768) {
    if (mode == kDx) return {wg_kernel<kDx, H>, wg_smem<H>(), kWgThreads, kVP};
    return {wg_kernel<kDw, H>, wg_smem<H>(), kWgThreads, kVP, true};
  } else {
    if (mode == kDx)
      return {tc_kernel<kDx, 32, H>, tc_smem_bytes<32, H>(kDx), kThreads, 32};
    return {tc_kernel<kDw, 32, H>, tc_smem_bytes<32, H>(kDw), kThreads, 32};
  }
}

// mode 0-2, dtype 0 (f32) or 1 (bf16), H one of the six; false otherwise
bool pick(int mode, int dtype, int H, Kernel* k) {
  if (mode < 0 || mode > 2) return false;
  switch (H) {
    case 64: *k = pick_h<64>(mode, dtype); return true;
    case 128: *k = pick_h<128>(mode, dtype); return true;
    case 256: *k = pick_h<256>(mode, dtype); return true;
    case 512: *k = pick_h<512>(mode, dtype); return true;
    case 768: *k = pick_h<768>(mode, dtype); return true;
    case 1024: *k = pick_h<1024>(mode, dtype); return true;
    default: return false;
  }
}

}  // namespace

// bytes of the workspace that fused_lce needs for (mode, dtype, H, n,
// vocab) on `num_sms` SMs (0: none); -1 for arguments it does not take
extern "C" long long fused_lce_workspace(int mode, int dtype, int H, int n,
                                         int vocab, int num_sms) {
  Kernel k;
  if (n <= 0 || vocab <= 0 || num_sms <= 0 || !pick(mode, dtype, H, &k))
    return -1;
  return k.split ? (long long)dw_ws_bytes(dw_split(n, vocab, num_sms), H)
                 : 0;
}

// mode: 0 forward (B4: nll, lse), 1 dx (B5), 2 dw (B6); dtype: 0 f32,
// 1 bf16 (x and w share it). x [n, H], w [vocab, H], out [n or vocab,
// H], all rows contiguous and 16-byte aligned; labels int32 [n]; lse,
// g f32 [n]; ws: fused_lce_workspace bytes (256-byte aligned) or null
// when that is 0. Returns cudaGetLastError() of the launch.
extern "C" int fused_lce(int mode, int dtype, int H, const void* x,
                         const void* w, const int* labels, const float* lse,
                         const float* g, float* nll, float* lse_out, void* out,
                         void* ws, int n, int vocab, int num_sms,
                         void* stream) {
  Kernel k;
  if (n <= 0 || vocab <= 0 || num_sms <= 0 || !pick(mode, dtype, H, &k))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  const int rows = mode == kDw ? vocab : n;
  int grid = (rows + k.rows - 1) / k.rows;
  p.ws = nullptr;
  p.count = nullptr;
  p.full = grid;
  p.pieces = 1;
  p.piece_tokens = n;
  cudaError_t err = cudaSuccess;
  if (k.split) {
    const Split sp = dw_split(n, vocab, num_sms);
    if (sp.split_tiles > 0) {
      if (ws == nullptr) return cudaErrorInvalidValue;
      p.ws = static_cast<float*>(ws);
      p.count = reinterpret_cast<int*>(
          static_cast<char*>(ws) + dw_ws_bytes(sp, H) - sp.split_tiles * 4);
      err = cudaMemsetAsync(p.count, 0, sp.split_tiles * 4, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    p.full = sp.full;
    p.pieces = sp.pieces;
    p.piece_tokens = sp.tiles * kTQ;
    grid = sp.full + sp.split_tiles * sp.pieces;
  }
  err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  k.fn<<<grid, k.threads, k.bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// what fused_lce launches for (mode, dtype, H): registers and local
// (spilled) bytes a thread, threads and shared bytes a block, and the
// blocks an SM holds at once
extern "C" int fused_lce_occupancy(int mode, int dtype, int H, int* out) {
  Kernel k;
  if (!pick(mode, dtype, H, &k)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, k.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], k.fn,
                                                        k.threads, k.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = k.threads;
  out[3] = static_cast<int>(k.bytes);
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
