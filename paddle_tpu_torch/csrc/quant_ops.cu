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
// 38.6 MB read once (12.0 us at 3.35 TB/s with x and the output). Its
// 2 M flops per byte would take ~9 us on the CUDA cores' f32 FMAs alone,
// so the products run on the tensor cores.
//
// Design (`dq_stream`): the table streams through shared memory as
// table_stream.cuh describes (TMA into an mbarrier ring of eight 16 KB
// slots, one block an SM: one producer warp, four consumer warps of 32
// table rows), and each slot is multiplied with
// mma.sync m16n8k16 f16 -> f32: table rows are the m16 side, x rows the n8
// side. An int8 value is exact in f16; a lane turns four table bytes into
// two f16 pairs with two byte permutes (1024 + (v + 128) as f16 bits) and
// two f16x2 subtractions, never the int-to-float unit. x is f32, which f16
// cannot hold, so each x row is split once per block into two f16 pieces of
// x * 2^s (s a power of two per row that puts its abs-max in [2^14, 2^15)):
// hi = f16(x 2^s), mid = f16(x 2^s - hi). Each piece's products are exact
// in f32 and the pieces together carry x within 2^-22 of each element
// (22 of its 24 significand bits; the elements below the f16 range of the
// row's scale lose less than 2^-39 of the row's abs-max), so the gate
// (rtol = atol = 1e-5 against the f32 plain version) holds with a wide
// margin; a third piece would make x exact for a third more products and
// staging. The two pieces are two n8 products of each fragment. Each slot
// (128 of K) is summed in a fresh tensor-core accumulator and added to the
// row's f32 total in registers, so the tensor cores' accumulation rounds
// only partial sums of 128 products. The epilogue adds the pieces, undoes
// 2^s (exact) and applies scale[n] / 127 as the reference does (IEEE
// division; built without fast-math). Each output is owned by one lane of
// one block and K is summed in a fixed order, so results repeat bit for
// bit. x tiles of 8 or 16 rows (blockIdx.y over more); ragged M, N and K
// are masked, never padded.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "table_stream.cuh"

namespace {

using namespace tstream;

constexpr int kXBudget = 64 * 1024;   // staged x bytes (4 a value: 2 f16)
constexpr int kStages = 8;            // ring slots: 128 KB in flight an SM

struct DqArgs {
  Table t;
  const float* x;
  long long ldx;
  int M;
  const float* scale;
  int scale_stride;
  float* out;
  int ks_seg;
  int tma;
};

// offset in halves of piece p of x[r][kl] (kl inside the staged segment):
// lane (g, t) of n8 group r / 8 reads 8 halves at a time, in K order
// permuted as the table's (table_stream.cuh): physical k 32 t + 8 i + e of
// each 128-byte step
template <int NG>
__device__ __forceinline__ int x_off(int r, int kl, int p) {
  const int kb = kl >> 7, w = kl & 127;
  const int t = w >> 5, i = (w & 31) >> 3, e = w & 7;
  return (((kb * 4 + i) * 2 + p) * NG + (r >> 3)) * 256 +
         (4 * (r & 7) + t) * 8 + e;
}

// four int8 table values -> two f16 pairs (bytes 0, 1 and 2, 3)
__device__ __forceinline__ void i8_to_f16(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;          // v + 128
  lo = __byte_perm(u, 0x64646464u, 0x5140);    // f16 1024 + v + 128
  hi = __byte_perm(u, 0x64646464u, 0x5342);
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(lo) : "r"(0x64806480u));
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(hi) : "r"(0x64806480u));
}

__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NG>
struct DqOp {
  static constexpr int kR = 8 * NG;      // x rows of the block
  static constexpr int kRW = kR / kWarps;   // of them, this warp's
  static constexpr int kUK = 48 / kRW;   // a row's values a lane loads at once
  static constexpr int kChunk = 32 * kUK;   // a row's K a warp loads at once
  const DqArgs& p;
  const Layout& L;
  float* unpow2;                         // 2^-s of each x row (shared)
  float* scale0;                         // the one scale (scale_stride 0)
  float pow2[kRW];                       // 2^s of this warp's rows
  int m0, warp, lane;
  bool staged;                           // init staged all of x
  float scl[2][2];                       // per-row scale[n] of the lane's rows
  float tot[2][2][NG][4];                // [fragment][piece][group][c]

  __device__ DqOp(const DqArgs& p_, const Layout& L_) : p(p_), L(L_) {
    unpow2 = L.ptr<float>(L.scratch);
    scale0 = unpow2 + 16;
    m0 = blockIdx.y * kR;
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    zero();
  }

  __device__ void zero() {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int c = 0; c < 4; ++c) tot[f][q][ng][c] = 0.f;
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

  // the two pieces of a loaded chunk at segment offset kl0, up to span
  __device__ void split(const float (&v)[kRW][kUK], int kl0, int span) {
    __half* xs = L.ptr<__half>(L.x);
#pragma unroll
    for (int j = 0; j < kRW; ++j) {
      const int r = warp + kWarps * j;
#pragma unroll
      for (int u = 0; u < kUK; ++u) {
        const int kl = kl0 + lane + 32 * u;
        if (kl >= span) continue;
        const float y = v[j][u] * pow2[j];   // exact: a power of two
        const __half hi = __float2half_rn(y);
        xs[x_off<NG>(r, kl, 0)] = hi;
        xs[x_off<NG>(r, kl, 1)] = __float2half_rn(y - __half2float(hi));
      }
    }
  }

  // each row's power-of-two scale s from its abs-max over all of K: s
  // puts it in [2^14, 2^15), inside f16's range (1 for a row of zeros or
  // one that is not finite); when all of x fits one chunk and one
  // segment, its pieces are staged from the same loads
  __device__ void init() {
    const int kp = (p.t.K + kStepK - 1) / kStepK * kStepK;
    staged = p.t.K <= kChunk && kp <= p.ks_seg;
    // one load of a scale shared by every row (every thread loading it
    // would queue thousands of requests on one L2 line)
    if (p.scale_stride == 0 && threadIdx.x == 0) *scale0 = __ldg(p.scale);
    float amax[kRW];
#pragma unroll
    for (int j = 0; j < kRW; ++j) amax[j] = 0.f;
    float v[kRW][kUK];
    for (int k0 = 0; k0 < p.t.K; k0 += kChunk) {
      load(v, k0);
#pragma unroll
      for (int j = 0; j < kRW; ++j)
#pragma unroll
        for (int u = 0; u < kUK; ++u) amax[j] = fmaxf(amax[j], fabsf(v[j][u]));
    }
#pragma unroll
    for (int j = 0; j < kRW; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
      // amax in [2^(E-127), 2^(E-126)) for its biased exponent E, so s =
      // 141 - E (at most 126: 2^s must be a normal float)
      const int E = (__float_as_int(amax[j]) >> 23) & 0xff;
      const int s = amax[j] > 0.f && E < 255 ? min(141 - E, 126) : 0;
      pow2[j] = __int_as_float((127 + s) << 23);
      if (lane == 0)
        unpow2[warp + kWarps * j] = __int_as_float((127 - s) << 23);
    }
    if (staged) split(v, 0, kp);
  }

  // K segment seg of this warp's rows -> the two pieces, zero past M and
  // K (init staged them already when x fits at once)
  __device__ void stage(int seg) {
    if (staged) return;
    const int kp = (p.t.K + kStepK - 1) / kStepK * kStepK;
    const int k0 = seg * p.ks_seg, span = min(p.ks_seg, kp - k0);
    float v[kRW][kUK];
    for (int kl = 0; kl < span; kl += kChunk) {
      load(v, k0 + kl);
      split(v, kl, span);
    }
  }

  __device__ void step(const uint32_t (&a)[2][2][8], int kbl) {
    float acc[2][2][NG][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[f][q][ng][c] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // x chunk i: k steps 2i, 2i + 1
      uint32_t b[2][NG][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
          lds128(L.x + (((kbl * 4 + i) * 2 + q) * NG + ng) * 512 + lane * 16,
                 b[q][ng]);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * i + jj;
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          uint32_t fa[4];
          i8_to_f16(a[f][0][j], fa[0], fa[2]);
          i8_to_f16(a[f][1][j], fa[1], fa[3]);
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int ng = 0; ng < NG; ++ng)
              mma_f16(acc[f][q][ng], fa, b[q][ng][2 * jj],
                      b[q][ng][2 * jj + 1]);
        }
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int c = 0; c < 4; ++c) tot[f][q][ng][c] += acc[f][q][ng][c];
  }

  // the per-row scales of the lane's table rows 16 f + g + 8 h
  __device__ void start(int tile) {
    if (p.scale_stride == 0) return;
    const int g = lane >> 2;
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * kTileRows + 32 * warp + 16 * f + g + 8 * h;
        scl[f][h] = n < p.t.N
            ? __ldg(p.scale + static_cast<long long>(n) * p.scale_stride)
            : 0.f;
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
        const float s = (p.scale_stride ? scl[f][h] : *scale0) / 127.0f;
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * ng + 2 * t4 + e;
            if (m0 + r >= p.M) continue;
            const int c = 2 * h + e;
            const float v = (tot[f][0][ng][c] + tot[f][1][ng][c]) * unpow2[r];
            p.out[static_cast<long long>(m0 + r) * p.t.N + n] = v * s;
          }
      }
    zero();
  }
};

template <int NG>
__global__ void __launch_bounds__(kThreads, 1)
    dq_stream(const __grid_constant__ CUtensorMap map,
              const __grid_constant__ DqArgs p) {
  extern __shared__ uint4 smem4[];
  const Layout L(smem4, kStages);
  DqOp<NG> op(p, L);
  run(&map, p.tma != 0, p.t, L, op, p.ks_seg);
}

template <int NG>
size_t dq_smem(int ks_seg) {
  return fixed_bytes(kStages) + static_cast<size_t>(8 * NG) * ks_seg * 4;
}

template <int NG>
int dq_seg(int K) {
  return seg_k(K, 8 * NG * 4, kXBudget);
}

template <int NG>
cudaError_t dq_run(DqArgs args, int num_sms, cudaStream_t st) {
  CUtensorMap map = {};
  args.tma = table_map(&map, args.t);
  args.ks_seg = dq_seg<NG>(args.t.K);
  return launch(dq_stream<NG>, map, args, args.t.N,
                (args.M + 8 * NG - 1) / (8 * NG), dq_smem<NG>(args.ks_seg),
                num_sms, st);
}

}  // namespace

extern "C" int dequant_matmul_f32_i8(const float* x, const int8_t* q,
                                     const float* scale, float* out, int M,
                                     int N, int K, long long ldx,
                                     long long ldq, int scale_stride,
                                     int num_sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * static_cast<size_t>(M) * N, st));
  DqArgs args = {};
  args.t = Table{q, ldq, 1, N, K};
  args.x = x;
  args.ldx = ldx;
  args.M = M;
  args.scale = scale;
  args.scale_stride = scale_stride;
  args.out = out;
  const cudaError_t err = M <= 8 ? dq_run<1>(args, num_sms, st)
                                 : dq_run<2>(args, num_sms, st);
  return static_cast<int>(err);
}

// what dequant_matmul_f32_i8 launches for M rows of x and depth K:
// registers and local (spilled) bytes a thread, threads and shared bytes
// a block, and the blocks an SM holds at once
extern "C" int dequant_matmul_occupancy(int M, int K, int* out) {
  if (M <= 8) return occupancy(dq_stream<1>, dq_smem<1>(dq_seg<1>(K)), out);
  return occupancy(dq_stream<2>, dq_smem<2>(dq_seg<2>(K)), out);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
