// The serving head's table stream, shared by B7 (dequant_matmul,
// quant_ops.cu) and B8 (w8a8_matmul, lowp.cu): an int8 table [N, K],
// element (n, k) at q[n * sn + k * sk], streamed once through shared
// memory and multiplied on the tensor cores by a few activation rows.
//
// The table's rows are the M side of mma.sync (m16), the activation rows
// the N side (n8 groups of 8 rows), so a handful of decode rows still fill
// the products. A block is one producer warp and kWarps consumer warps.
// The producer walks the block's items — (tile of kTileRows table rows,
// K step of 128 bytes), tiles blockIdx.x, blockIdx.x + gridDim.x, ... —
// into a ring of `stages` slots of [128 rows][128 bytes], each one
// 128-byte swizzled (16-byte chunk c of row r at chunk c ^ (r % 8)):
// by TMA from one lane when a tensor map can describe the table (K-major,
// row stride a multiple of 16 bytes, 16-byte aligned base), otherwise by
// byte loads from all 32 lanes, in the same layout (a table whose row
// stride is not a multiple of 16 bytes, or the MN-major [K, N] layout).
// Rows past N and K past K arrive as zeros (TMA's out-of-bounds fill, or
// the byte loads' mask), so nothing is padded. Full / empty mbarriers
// mark the slots.
//
// Each consumer warp owns 32 rows of a tile (two m16 fragments). Inside
// a 128-byte K step, lane (g, t) = (lane / 4, lane % 4) reads the 32
// bytes [32 t, 32 t + 32) of its rows g and g + 8 (two 16-byte loads a
// row, free of bank conflicts under the swizzle), and the K order inside
// the step is permuted so that those bytes are exactly the lane's
// fragment elements: the activations are staged in shared memory under
// the same permutation (`x_off`), so the sums are unchanged. The lane
// releases the slot as soon as its bytes are in registers.
//
// The activation rows of the block's x tile (8 * NG rows, blockIdx.y)
// are staged by the consumers once per block when they fit (K up to
// `ks_seg`), else one K segment at a time at each tile's segment starts.
// While the stream fills the memory system a global load waits long, so
// each lane issues all its x loads of a chunk at once, and a scalar that
// every block reads is loaded by one thread a block (one load from every
// thread queues thousands of requests on one L2 line). The grid is
// persistent, one block an SM with a deep ring (the kernels pick the
// depth): with one tile a block, every block's last slots would wait on
// its staging and the stream would stall.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace tstream {

using namespace sm90;

constexpr int kTileRows = 128;                  // table rows a tile
constexpr int kStepK = 128;                     // K bytes a ring slot
constexpr uint32_t kSlot = kTileRows * kStepK;  // 16 KB
constexpr int kWarps = 4;                       // consumers, 32 rows each
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;       // + the producer warp

// shared bytes before the staged activations: the ring (1024-aligned),
// its full and empty barriers, 128 bytes of scratch
constexpr size_t fixed_bytes(int stages) {
  return 1024 + (size_t)stages * kSlot + 16 * stages + 128;
}

struct Table {
  const int8_t* q;
  long long sn, sk;
  int N, K;
};

struct Layout {
  int stages;
  uint32_t ring, full, empty, scratch, x;
  char* base;        // generic address of byte 0 of the raw allocation
  uint32_t raw;
  __device__ Layout(uint4* smem, int stages_) : stages(stages_) {
    base = reinterpret_cast<char*>(smem);
    raw = smem_u32(smem);
    ring = (raw + 1023) & ~1023u;
    full = ring + stages * kSlot;
    empty = full + 8 * stages;
    scratch = empty + 8 * stages;
    x = scratch + 128;
  }
  template <typename T>
  __device__ T* ptr(uint32_t addr) const {
    return reinterpret_cast<T*>(base + (addr - raw));
  }
};

__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kStepK + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

__device__ __forceinline__ void lds128(uint32_t addr, uint32_t* v) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr));
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint32_t* v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// one slot of table rows [tile * 128, +128) x K [ks * 128, +128) by byte
// loads from the 32 lanes of the producer warp, zeros outside the table;
// consecutive lanes walk the table's contiguous axis
__device__ __forceinline__ void fill(const Table& t, uint32_t dst, int tile,
                                     int ks, int lane) {
  const bool n_fast = t.sk != 1;
  for (int c = lane; c < kTileRows * 8; c += 32) {
    const int r = n_fast ? c % kTileRows : c / 8;
    const int ch = n_fast ? c / kTileRows : c % 8;
    const int n = tile * kTileRows + r, k0 = ks * kStepK + ch * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (n < t.N) {
      const int8_t* p = t.q + n * t.sn + k0 * t.sk;
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (k0 + b < t.K)
          w[b >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           __ldg(p + b * t.sk)))
                       << (8 * (b & 3));
    }
    sts128(dst + swz(r, ch * 16), w);
  }
}

// the producer warp: the block's items into the ring
__device__ __forceinline__ void produce(const CUtensorMap* map, bool tma,
                                        const Table& t, const Layout& L,
                                        int lane) {
  if (tma && lane != 0) return;
  const int steps = (t.K + kStepK - 1) / kStepK;
  const int tiles = (t.N + kTileRows - 1) / kTileRows;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int ks = 0; ks < steps; ++ks, ++i) {
      const int s = i % L.stages;
      if (i >= L.stages) mbar_wait(L.empty + 8 * s, (i / L.stages - 1) & 1);
      const uint32_t dst = L.ring + s * kSlot;
      if (tma) {
        mbar_expect_tx(L.full + 8 * s, kSlot);
        tma_load(dst, map, ks * kStepK, tile * kTileRows, L.full + 8 * s);
      } else {
        fill(t, dst, tile, ks, lane);
        mbar_arrive(L.full + 8 * s);
      }
    }
}

// The consumers' walk over the same items. `op` starts a tile
// (`op.start(tile)`: its loads fly while the tile streams), stages the
// activations (`op.stage(seg)`, K segment seg of ks_seg bytes), multiplies
// one slot (`op.step(a, kbl)`: a[f][h][w] = word w of this lane's 32 bytes
// of row 32 warp + 16 f + g + 8 h; kbl the K step inside the segment) and
// finishes a tile (`op.finish(tile)`).
template <class Op>
__device__ __forceinline__ void consume(Op& op, const Table& t,
                                        const Layout& L, int ks_seg) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int steps = (t.K + kStepK - 1) / kStepK;
  const int tiles = (t.N + kTileRows - 1) / kTileRows;
  const int seg_steps = ks_seg / kStepK;
  const bool segmented = steps > seg_steps;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    op.start(tile);
    for (int ks = 0; ks < steps; ++ks, ++i) {
      const int kbl = ks % seg_steps;
      if (i == 0 || (segmented && kbl == 0)) {
        if (i > 0) bar_consumers();     // every warp is done with the last
        op.stage(ks / seg_steps);
        bar_consumers();
      }
      const int s = i % L.stages;
      mbar_wait(L.full + 8 * s, (i / L.stages) & 1);
      const uint32_t slot = L.ring + s * kSlot;
      uint32_t a[2][2][8];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 32 * warp + 16 * f + g + 8 * h;
          lds128(slot + swz(r, 32 * t4), &a[f][h][0]);
          lds128(slot + swz(r, 32 * t4 + 16), &a[f][h][4]);
        }
      mbar_arrive(L.empty + 8 * s);
      op.step(a, kbl);
    }
    op.finish(tile);
  }
}

// set up the barriers, then split the block into producer and consumers
template <class Op>
__device__ __forceinline__ void run(const CUtensorMap* map, bool tma,
                                    const Table& t, const Layout& L, Op& op,
                                    int ks_seg) {
  if (tma && threadIdx.x == kConsumers)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(map))
                 : "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(L.full + 8 * s, tma ? 1 : 32);
      mbar_init(L.empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(map, tma, t, L, threadIdx.x & 31);
    return;
  }
  op.init();
  consume(op, t, L, ks_seg);
}

// a tensor map of the table in [128 rows][128 bytes] boxes, 128-byte
// swizzled, when TMA can read it: K-major rows, a row stride that is a
// multiple of 16 bytes, a 16-byte aligned base
inline bool table_map(CUtensorMap* map, const Table& t) {
  if (t.sk != 1 || t.sn % 16 != 0 || t.sn <= 0 ||
      reinterpret_cast<uintptr_t>(t.q) % 16 != 0)
    return false;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)t.K, (cuuint64_t)t.N};
  const cuuint64_t strides[1] = {(cuuint64_t)t.sn};
  const cuuint32_t box[2] = {(cuuint32_t)kStepK, (cuuint32_t)kTileRows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(t.q), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K staged at once: all of K rounded up to the step when the block's
// x_bytes_per_k * K fit in `budget` bytes, else the largest multiple of
// the step that does
inline int seg_k(int K, int x_bytes_per_k, int budget) {
  const int kp = (K + kStepK - 1) / kStepK * kStepK;
  const int cap = std::max(kStepK, budget / x_bytes_per_k / kStepK * kStepK);
  return std::min(kp, cap);
}

// launch `kernel` over the table's tiles: a persistent grid of one block
// an SM, times the x tiles
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, const CUtensorMap& map, const Args& args,
                   int N, int x_tiles, size_t smem, int num_sms,
                   cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kTileRows - 1) / kTileRows;
  const dim3 grid(std::min(tiles, num_sms), x_tiles);
  kernel<<<grid, kThreads, smem, st>>>(map, args);
  return cudaGetLastError();
}

// registers, local bytes, threads, shared bytes and blocks an SM of
// `kernel` at `smem` bytes (the occupancy entries' report)
template <typename Kernel>
int occupancy(Kernel kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kThreads;
  out[3] = static_cast<int>(smem);
  return 0;
}

}  // namespace tstream
