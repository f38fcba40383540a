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
// Design. One kernel shape serves all three: a block OWNS a tile of rows of
// one operand ("a": x for B4 / B5, w for B6), kept in shared memory for the
// whole block, and WALKS the other operand ("b": w for B4 / B5, x for B6) in
// tiles of 64 rows (B4 in bf16: 128). Each step loads the b tile, forms the
// score tile a b^T over all of H, then either folds it into the per-row online
// statistics (B4) or turns it into d and adds d b (B5: dx rows of the owned x
// rows) or d^T b (B6: dw rows of the owned vocab rows) into f32 accumulators
// held in registers. The TPU kernels keep a [256, 768] dx and a [1024, 768] dw
// accumulator in VMEM (3 MB); here the register file (256 KB an SM) holds
// them. B5 owns row tiles and walks the vocab, B6 owns vocab tiles and walks
// the rows, so every output element is summed by one thread in a fixed order:
// no atomics, results repeat bit for bit. Columns past V and rows past N are
// zero-filled by the copies and masked in d.
//
// B4 in bf16 (lse_kernel, every H): warpgroup products (wgmma) fed by
// TMA. A block owns 128 token rows (64 at H 1024), so the table streams
// through L2 once per 128 tokens (16384 / 128 = 128 times at the ERNIE
// head, one block on each of 128 SMs) instead of once per 64; its x
// tile stays in 128-byte-swizzled shared memory, a producer warp walks
// the table in [128 vocab rows, 32 or 64 columns] items through a ring
// of mbarrier-guarded slots, and each consumer warpgroup folds its
// m64n128 score tile into the rows' online statistics in registers
// while the next tile's products run. See lse_kernel. At the ERNIE head
// on an H100 80GB HBM3 (700 W) it takes about 1.1 ms against 3.9 ms for
// the mma.sync kernel it replaced (64 owned rows, a cp.async ring; both
// in one chip_ab.py call) and 2.45 ms for the unfused two-call forward
// (chip_smoke.py); 2.4x its 0.458 ms bound (operations). The walk is
// bound by the bytes it keeps in flight (see lse_kernel).
//
// B5 / B6 at H 1024 (tc_kernel): warp-level mma.sync.m16n8k16 (bf16
// in, f32 accumulators), fragments loaded with ldmatrix, 32 owned rows,
// their [32, 1024] f32 accumulator spread over 8 warps; the walked tile
// sits in shared memory as H / 64 chunk slots filled by cp.async, a
// slot refilled with the next tile's chunk as soon as the block is done
// with it. d is rounded to bf16 into shared memory and read back as the
// A operand of the second product, whose B operand (the walked tile,
// K = its rows) is transposed on load with ldmatrix.trans. Shared-memory
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
// Every tensor-core kernel is a template on its 16-bit operand type T,
// instantiated for bf16 (amp's default) and f16 (float16 amp): wgmma and
// mma.sync take .f16 operands in the layouts of .bf16, the TMA maps read
// CU_TENSOR_MAP_DATA_TYPE_FLOAT16, and d is rounded to T at the same
// point in both (csrc/half16.cuh). A float16 tensor launches the f16
// instantiation; it is never converted to reach the bf16 one.
//
// f32 operands (tests, steps without amp) take a CUDA-core path of the
// same shape in full f32 (no TF32). H is a multiple of 64 up to 1024
// (one instantiation each of 64, 128, 256, 512, 768, 1024); N and V are
// arbitrary.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "half16.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using half16::mma16816;
using half16::pack2;

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
constexpr size_t tc_smem_bytes() {
  return (size_t)BP * (H + 8) * 2 + (size_t)(H / kKC) * kBQ * kLDC * 2 +
         (size_t)BP * (kBQ + 8) * 2;
}

// Copy H-chunk `c` of the walked tile's rows b0.. (zeros past nb) into
// its slot, as one commit group. Always commits, copying nothing past
// the last tile, so every thread counts the same groups.
template <int H, typename T>
__device__ __forceinline__ void fetch_chunk(T* Bs, const T* b, int b0,
                                            int nb, int c) {
  T* slot = Bs + c * kBQ * kLDC;
  for (int i = threadIdx.x; i < kBQ * (kKC / 8); i += kThreads) {
    const int r = i / (kKC / 8), v = i % (kKC / 8);
    const bool ok = b0 + r < nb;
    const T* src = b + (ok ? (size_t)(b0 + r) * H + c * kKC + v * 8 : 0);
    cp_async16(slot + r * kLDC + v * 8, src, ok);
  }
  cp_async_commit();
}

// B5 / B6 at H 1024: BP owned rows (32). The walked tile lives in
// shared memory as NC = H / 64 chunk slots of [kBQ, 64]; a slot is
// refilled with the next tile's chunk as soon as every warp is done
// with it in the second product, so the loads of tile i+1 run under
// the products of tile i. Warps split the score tile [BP, kBQ] into
// WM x WN tiles of 16 x (kBQ / WN); in the second product warp w owns
// columns [64 c + 8 w, 64 c + 8 w + 8) of every chunk c of the [BP, H]
// accumulator.
template <int MODE, int BP, int H, typename T>
__global__ void __launch_bounds__(kThreads, 1) tc_kernel(const Args p) {
  constexpr int LDA = H + 8;          // owned-tile row stride (bf16)
  constexpr int NC = H / kKC;         // chunks of the walked tile
  constexpr int WM = BP / 16, WN = kWarps / WM;
  constexpr int NJ = kBQ / WN / 8;    // n8 tiles of a warp's score tile
  constexpr int MI = BP / 16;         // m16 tiles of the accumulator
  constexpr int LDD = kBQ + 8;        // d tile row stride (bf16)
  static_assert(NJ % 2 == 0, "score tiles pair n8 tiles");
  static_assert(MODE == kDx || MODE == kDw, "backward modes");

  extern __shared__ uint4 smem4[];
  T* As = reinterpret_cast<T*>(smem4);
  T* Bs = As + BP * LDA;
  void* tail = Bs + NC * kBQ * kLDC;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = (warp % WM) * 16, q0 = (warp / WM) * (kBQ / WN);
  const int a0 = blockIdx.x * BP;
  const int na = rows_a<MODE>(p), nb = rows_b<MODE>(p);
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);

  // the owned tile (one group), then every chunk of the first walked tile
  for (int i = threadIdx.x; i < BP * (H / 8); i += kThreads) {
    const int r = i / (H / 8), v = i % (H / 8);
    const bool ok = a0 + r < na;
    cp_async16(As + r * LDA + v * 8, A + (ok ? (size_t)(a0 + r) * H + v * 8
                                             : 0), ok);
  }
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < NC; ++c) fetch_chunk<H, T>(Bs, B, 0, nb, c);

  // B5: per-token operands of the thread's two owned rows
  float lse_r[2] = {0.f, 0.f}, g_r[2] = {0.f, 0.f};
  int lab_r[2] = {-1, -1};
  if (MODE == kDx) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = a0 + m0 + g + 8 * h;
      if (t < p.n) {
        lab_r[h] = p.labels[t];
        lse_r[h] = p.lse[t];
        g_r[h] = p.g[t];
      }
    }
  }

  float acc[MI][NC][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][c][e] = 0.f;

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
      // in flight past chunk c: this tile's later chunks
      cp_async_wait_n(NC - 1 - c);
      __syncthreads();  // chunk c visible
      const T* slot = Bs + c * kBQ * kLDC;
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
          mma16816<T>(s[j], a, b[0], b[1]);
          mma16816<T>(s[j + 1], a, b[2], b[3]);
        }
      }
    }

    // d of the tile, rounded to T, into shared memory
    T* Ds = static_cast<T*>(tail);
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
            pack2<T>(d[0], d[1]);
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
      const T* slot = Bs + c * kBQ * kLDC;
#pragma unroll
      for (int ks = 0; ks < kBQ / 16; ++ks) {
        uint32_t b[2];
        ldsm_x2_trans(b, slot + (ks * 16 + (lane & 15)) * kLDC + warp * 8);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mma16816<T>(acc[mi][c], ad[mi][ks], b[0], b[1]);
      }
      __syncthreads();  // every warp is done with chunk c
      fetch_chunk<H, T>(Bs, B, b1, nb, c);
    }
  }

  cp_async_wait<0>();   // the empty groups past the last tile
  T* out = static_cast<T*>(p.out);
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
            pack2<T>(acc[mi][c][2 * h], acc[mi][c][2 * h + 1]);
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
// d[64 x N] (+)= A B, bf16 from shared memory through descriptors; the
// f32 accumulator of lane (g, t) of warp w: d[4 j + 2 h + e] is row
// 16 w + g + 8 h, column 8 j + 2 t + e
#define FL_WGMMA_N32(TY) \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15},"                            \
      " %16, %17, p, 1, 1, 0, %19;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15])                                                       \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B))
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (half16::kF16<T>)
    FL_WGMMA_N32("f16");
  else
    FL_WGMMA_N32("bf16");
}
#undef FL_WGMMA_N32
#define FL_WGMMA_N64(TY) \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7,"                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15,"                             \
      "%16, %17, %18, %19, %20, %21, %22, %23,"                           \
      "%24, %25, %26, %27, %28, %29, %30, %31},"                          \
      " %32, %33, p, 1, 1, 0, %35;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),       \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),  \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),  \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),  \
        "+f"(d[30]), "+f"(d[31])                                          \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B))
template <typename T, int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (half16::kF16<T>)
    FL_WGMMA_N64("f16");
  else
    FL_WGMMA_N64("bf16");
}
#undef FL_WGMMA_N64

// PW columns a part (one wgmma n: 64, or 32 at H = 64, where the two
// warpgroups split the only chunk), NP parts a warpgroup
template <int MODE, int H, typename T>
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
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
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
          wgmma_n32<T, 0>(s, wg_desc(a_s + c * kChunk + kk * 32, 16, 1024),
                       wg_desc(b_s + c * kChunk + wg * 32 * 128 + kk * 32,
                               16, 1024),
                       (c | kk) != 0);
      wg_commit();
    }
    wg_wait<0>();
    reg_fence(s);

    // d of the tile, rounded to T, into D [owned row][walked row]
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
                     "r"(pack2<T>(d[0], d[1])));
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
          wgmma_n64<T, 1>(acc[pp], da, db, 1);
        else
          wgmma_n32<T, 1>(acc[pp], da, db, 1);
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

  T* out = static_cast<T*>(p.out);
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
              pack2<T>(acc[pp][4 * j + 2 * h],
                       acc[pp][4 * j + 2 * h + 1]);
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
        pack2<T>(sum.x, sum.y);
  }
}

// ---------------------------------------------------------------------------
// B4 in bf16 on warpgroup products (wgmma), every H
// ---------------------------------------------------------------------------
// A block owns kRows token rows of x (128: two consumer warpgroups of
// m64, up to H 768; 64 at H 1024, where 128 rows of x would not fit)
// and walks the table in tiles of 128 vocab rows. A producer warp keeps
// the walk in flight with TMA: x once ([kRows, H] as H / 64 chunks of
// [kRows rows][128 bytes], 128-byte swizzled), then each tile as items
// of [128 vocab rows][kIW columns] through a ring of kStages slots
// (full / empty mbarriers). How many bytes are in flight bounds the
// walk (L2 answers a block's load in about a microsecond under this
// load): at H 768, x takes 192 KB and leaves room for two 16 KB items
// or four 8 KB ones, so items there are 32 columns (64-byte rows,
// 64-byte swizzle); elsewhere 64. Each consumer warpgroup forms its
// m64n128 score tile item by item (k16 products, both operands K-major
// from shared memory), so the next items' loads run under this one's
// products. The score tile is folded into the rows' online max /
// sum-exp / picked logit in registers; in the accumulator layout a
// row's 128 columns sit in the four threads of a quad, which keep one
// max (two shfl.xor) and each its own partial sum, added once at the
// end. Two accumulators alternate over the tiles: the fold of tile t-1
// runs on the CUDA cores while tile t's products run on the tensor
// cores (its max with the first item, its exps spread over the next
// ones). Every block walks the vocab from tile 0 up, and every row is
// owned by one block: a row's sums run in one order whatever the grid,
// and results repeat bit for bit.
// Vocab rows past V arrive as zeros (TMA fills out-of-bounds rows) and
// their columns are masked to -1e30.
template <int H, typename T_>
struct Fwd {
  using T = T_;                                  // operand type
  static constexpr int kWG = H <= 768 ? 2 : 1;   // consumer warpgroups
  static constexpr int kRows = 64 * kWG;         // owned token rows
  static constexpr int kNC = H / 64;             // 64-column chunks of x
  static constexpr uint32_t kXChunk = kRows * 128;
  static constexpr uint32_t kXBytes = kNC * kXChunk;
  static constexpr int kRoom = 232448 - 1024 - 128 - (int)kXBytes;
  // items of [128 vocab][kIW columns]: 64 (128-byte rows) where four
  // 16 KB slots fit beside x, else 32 (64-byte rows, four 8 KB slots)
  static constexpr int kIW = kRoom / (128 * 128) >= 4 ? 64 : 32;
  static constexpr int kNI = H / kIW;            // items a tile
  static constexpr int kK16 = kIW / 16;          // k16 products an item
  static constexpr uint32_t kItem = 128 * kIW * 2;
  static constexpr int kFit = kRoom / (int)kItem;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kThreads = 128 * kWG + 32;   // + the producer warp
  // alignment slack, x, the ring, full / empty barriers and x's barrier
  static constexpr size_t kSmem =
      1024 + kXBytes + (size_t)kStages * kItem + (2 * kStages + 1) * 8;
  // fold parts after the max: the exps of a tile spread over P items
  static constexpr int kParts = kNI > 4 ? 4 : (kNI > 2 ? 2 : 1);
  static_assert(kStages >= 2, "the ring needs two slots");
};

constexpr float kLog2e = 1.4426950408889634f;

#define FL_WGMMA_N128(TY) \
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
      "%56, %57, %58, %59, %60, %61, %62, %63"                            \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
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
      : "l"(da), "l"(db), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (half16::kF16<T>)
    FL_WGMMA_N128("f16");
  else
    FL_WGMMA_N128("bf16");
}
#undef FL_WGMMA_N128

// the online statistics of the thread's two rows (h: row g or g + 8 of
// its warp's 16); l and the picked logit are the thread's own columns'
// partials, m is the quad's
struct RowStats4 {
  float m[2], l[2], pk[2], ms[2];   // ms = m log2(e)
  int lab[2];
};

// the first part of folding the score tile s of vocab rows v0..: mask
// columns past the vocab, pick the label's score, take the running max
// and rescale l. Column of s[4 j + 2 h + e]: 8 j + 2 t4 + e.
__device__ __forceinline__ void fold_max(float (&s)[64], RowStats4& st,
                                         int v0, int vocab, int t4) {
  const int valid = vocab - v0 < 128 ? vocab - v0 : 128;
  if (valid < 128) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i >> 2) + 2 * t4 + (i & 1) >= valid) s[i] = kNegInf;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int want = st.lab[h] - v0;
    if ((unsigned)want < (unsigned)valid) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + 2 * t4 + e == want) st.pk[h] += s[4 * j + 2 * h + e];
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = group_max<4>(mx);
    const float mn = fmaxf(st.m[h], mx);
    st.l[h] *= exp2f((st.m[h] - mn) * kLog2e);
    st.m[h] = mn;
    st.ms[h] = mn * kLog2e;
  }
}

// the sum-exp of s's column groups j in [j0, j1) into l
__device__ __forceinline__ void fold_exp(const float (&s)[64], RowStats4& st,
                                         int j0, int j1) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < j0 || j >= j1) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st.l[h] += exp2f(fmaf(s[4 * j + 2 * h + e], kLog2e, -st.ms[h]));
  }
}

// shared memory of lse_kernel: x chunks, the ring, the barriers
template <class C>
struct FwdSmem {
  uint32_t x, ring, full, empty, xbar;
  __device__ __forceinline__ explicit FwdSmem(uint32_t raw) {
    x = (raw + 1023) & ~1023u;
    ring = x + C::kXBytes;
    full = ring + C::kStages * C::kItem;
    empty = full + 8 * C::kStages;
    xbar = empty + 8 * C::kStages;
  }
};

// the descriptor of a K-major [rows][64 bytes] operand, 64-byte swizzle
// (16-byte unit u of row r at u ^ ((r / 2) % 4)): the stride steps 8
// rows (512 bytes)
__device__ __forceinline__ uint64_t wg_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// the walk's t-th tile's products into `cur`, item by item, with the
// fold of the one before (`prev`, complete once the first item's wait
// returns) spread under them. `da` describes the warpgroup's rows of
// x's first chunk; every operand's descriptor is that of its chunk
// start plus a byte offset / 16 (the address field is the low 14 bits).
template <class C>
__device__ __forceinline__ void lse_tile(float (&cur)[64], float (&prev)[64],
                                         int t, const FwdSmem<C>& sm,
                                         uint64_t da, RowStats4& st,
                                         int vocab, int t4) {
  // opaque to the compiler, so it forms each chunk's descriptors where
  // they are used instead of holding all H / 16 of them in registers
  // across the walk
  asm volatile("" : "+l"(da));
#pragma unroll
  for (int c = 0; c < C::kNI; ++c) {
    const int j = t * C::kNI + c;
    const int slot = j % C::kStages;
    mbar_wait(sm.full + 8 * slot, (j / C::kStages) & 1);
    wg_fence();
    const uint32_t b = sm.ring + slot * C::kItem;
    const uint64_t db = C::kIW == 64 ? wg_desc(b, 16, 1024) : wg_desc64(b);
    // the item's columns: x chunk (c kIW) / 64, bytes (c kIW) % 64 * 2 in
#pragma unroll
    for (int kk = 0; kk < C::kK16; ++kk)
      wgmma_n128<typename C::T>(cur,
                 da + (((c * C::kIW / 64) * C::kXChunk +
                        (c * C::kIW % 64) * 2 + kk * 32) >> 4),
                 db + ((kk * 32) >> 4), (c | kk) != 0);
    wg_commit();
    wg_wait<1>();           // item j - 1 is done: release its slot
    if (j > 0) mbar_arrive(sm.empty + 8 * ((j - 1) % C::kStages));
    if (t == 0) continue;
    if (c == 0) {
      reg_fence(prev);
      fold_max(prev, st, (t - 1) * 128, vocab, t4);
      if (C::kNI == 1) fold_exp(prev, st, 0, 16);
    } else if (c <= C::kParts) {
      constexpr int kW = 16 / C::kParts;
      fold_exp(prev, st, (c - 1) * kW, c * kW);
    }
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(Fwd<H, T>::kThreads, 1)
    lse_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const Args p) {
  using C = Fwd<H, T>;
  extern __shared__ uint4 smem4[];
  const FwdSmem<C> sm(smem_u32(smem4));
  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.x * C::kRows;
  const int tiles = (p.vocab + 127) / 128;
  const int items = tiles * C::kNI;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 128 * C::kWG);
    }
    mbar_init(sm.xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C::kWG) {       // the producer warp; one thread issues
    if (tid != 128 * C::kWG) return;
    mbar_expect_tx(sm.xbar, C::kXBytes);
    for (int c = 0; c < C::kNC; ++c)
      tma_load(sm.x + c * C::kXChunk, &tx, c * 64, row0, sm.xbar);
    for (int j = 0; j < items; ++j) {
      const int slot = j % C::kStages;
      if (j >= C::kStages)
        mbar_wait(sm.empty + 8 * slot, (j / C::kStages - 1) & 1);
      mbar_expect_tx(sm.full + 8 * slot, C::kItem);
      tma_load(sm.ring + slot * C::kItem, &tw, (j % C::kNI) * C::kIW,
               (j / C::kNI) * 128, sm.full + 8 * slot);
    }
    return;
  }

  const int wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  RowStats4 st;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + wg * 64 + warp * 16 + g + 8 * h;
    st.m[h] = kNegInf;
    st.l[h] = 0.f;
    st.pk[h] = 0.f;
    st.ms[h] = 0.f;
    st.lab[h] = r < p.n ? p.labels[r] : -1;
  }
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  // this warpgroup's 64 rows of x's first chunk
  const uint64_t da = wg_desc(sm.x + wg * 64 * 128, 16, 1024);
  mbar_wait(sm.xbar, 0);

  for (int t = 0; t < tiles; t += 2) {
    lse_tile<C>(acc0, acc1, t, sm, da, st, p.vocab, t4);
    if (t + 1 < tiles)
      lse_tile<C>(acc1, acc0, t + 1, sm, da, st, p.vocab, t4);
  }
  wg_wait<0>();
  const int t_last = tiles - 1;
  if ((tiles - 1) & 1) {
    reg_fence(acc1);
    fold_max(acc1, st, t_last * 128, p.vocab, t4);
    fold_exp(acc1, st, 0, 16);
  } else {
    reg_fence(acc0);
    fold_max(acc0, st, t_last * 128, p.vocab, t4);
    fold_exp(acc0, st, 0, 16);
  }
  // every row has a valid column, so l >= 1 after the running max
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = group_sum<4>(st.l[h]), pk = group_sum<4>(st.pk[h]);
    const int r = row0 + wg * 64 + warp * 16 + g + 8 * h;
    if (t4 == 0 && r < p.n) {
      const float lse = st.m[h] + logf(l);
      p.lse_out[r] = lse;
      p.nll[r] = lse - pk;
    }
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
  const void* fn;
  size_t bytes;
  int threads, rows;
  bool split = false;   // B6 on warpgroup products: see dw_split
  int item_cols = 0;    // B4 in 16 bits: launched with tensor maps of x and
                        // w, w read in items of this many columns
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

template <typename F>
const void* sym(F* fn) {
  return reinterpret_cast<const void*>(fn);
}

// the 16-bit kernels of (mode, H) in operand type T
template <int H, typename T>
Kernel pick_tc(int mode) {
  using C = Fwd<H, T>;
  if (mode == kFwd)
    return {sym(lse_kernel<H, T>), C::kSmem, C::kThreads, C::kRows, false,
            C::kIW};
  // a 64-row f32 accumulator of 1024 columns would fill the register
  // file: H 1024 keeps the 32-row mma.sync kernel for B5 and B6
  if constexpr (H <= 768) {
    if (mode == kDx)
      return {sym(wg_kernel<kDx, H, T>), wg_smem<H>(), kWgThreads, kVP};
    return {sym(wg_kernel<kDw, H, T>), wg_smem<H>(), kWgThreads, kVP, true};
  } else {
    if (mode == kDx)
      return {sym(tc_kernel<kDx, 32, H, T>), tc_smem_bytes<32, H>(),
              kThreads, 32};
    return {sym(tc_kernel<kDw, 32, H, T>), tc_smem_bytes<32, H>(), kThreads,
            32};
  }
}

// dtype 0 (f32), 1 (bf16) or 2 (f16)
template <int H>
Kernel pick_h(int mode, int dtype) {
  if (dtype == 1) return pick_tc<H, __nv_bfloat16>(mode);
  if (dtype == 2) return pick_tc<H, __half>(mode);
  const size_t smem = f32_smem_bytes<H>();
  switch (mode) {
    case kFwd: return {sym(f32_kernel<kFwd, H>), smem, kThreads, kFP};
    case kDx: return {sym(f32_kernel<kDx, H>), smem, kThreads, kFP};
    default: return {sym(f32_kernel<kDw, H>), smem, kThreads, kFP};
  }
}

// a [rows, H] bf16 (dtype 1) or f16 (dtype 2) matrix (rows contiguous)
// read in boxes of [box_rows, box_cols (64 or 32) columns], swizzled by
// the box's row bytes (128 or 64); rows past `rows` read as zeros
bool half_map(CUtensorMap* map, int dtype, const void* base, int H,
              int rows, int box_rows, int box_cols) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map,
             dtype == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2,
             const_cast<void*>(base), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                            : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// mode 0-2, dtype 0 (f32), 1 (bf16) or 2 (f16), H one of the six; false
// otherwise
bool pick(int mode, int dtype, int H, Kernel* k) {
  if (mode < 0 || mode > 2 || dtype < 0 || dtype > 2) return false;
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
// 1 bf16, 2 f16 (x and w share it). x [n, H], w [vocab, H], out [n or vocab,
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
  if (k.item_cols) {
    CUtensorMap tx, tw;
    if (!half_map(&tx, dtype, x, H, n, k.rows, 64) ||
        !half_map(&tw, dtype, w, H, vocab, 128, k.item_cols))
      return cudaErrorInvalidValue;
    void* args[] = {&tx, &tw, &p};
    err = cudaLaunchKernel(k.fn, dim3(grid), dim3(k.threads), args, k.bytes,
                           st);
  } else {
    void* args[] = {&p};
    err = cudaLaunchKernel(k.fn, dim3(grid), dim3(k.threads), args, k.bytes,
                           st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
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
