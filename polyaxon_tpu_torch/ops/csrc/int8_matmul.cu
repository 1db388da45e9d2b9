// Weight-only int8 projection for Hopper (sm_90a):
//   y[m, n] = (sum_k x[m, k] * Wq[n, k] in f32) * scale[n], cast to x's type,
// for one x and up to four (Wq, scale, y) sets that share its K (a group:
// q/k/v, or gate/up), in one launch.
//
// Replaces: polyaxon_tpu/models/quant.py::Int8Dense (:85-90), which hands
// the int8 kernel straight to XLA's mixed dot_general(x, Wq,
// preferred_element_type=f32) and multiplies the f32 result by the
// per-output-channel scale. There is no Pallas kernel on that side; the
// contract kept here is the same one: no dequantized copy of the weights
// is ever written to device memory (int8 is widened to bf16 or f32 in
// registers and shared memory only), the sum is f32, the f32 scale is
// applied to the f32 sum, and the result is rounded to x's type once.
//
// Layouts: x [M, K] row-major (row stride ldx, elements), each Wq [N, K]
// int8 row-major (nn.Linear's [out, in], the stored buffer as it is), scale
// [N] f32, y [M, N] row-major with row stride ldy (the wrapper allocates
// one [M, sum N] buffer for a group, whose column slices are the members'
// outputs). K must be a multiple of 16 and the rows of x and Wq must start
// on 16-byte boundaries (the wrapper checks both; the TMA's tensor maps
// need the same of their row strides).
//
// What bounds it. Decode (M <= 8 rows) reads N*K weight bytes for 2*M*N*K
// operations: at M = 8 that is 16 operations per byte, far below the
// card's ~295 bf16 operations per byte, so the weight stream bounds it:
// one llama3-1b layer reads 60.8 MB of int8, 0.0184 ms at 3.35 TB/s.
// Prefill (M in the hundreds or thousands) is the other side of the line:
// 2*M*N*K operations on the tensor cores, 0.0695 ms for gate at M = 2048.
//
// The design does about that, by M. The seam sits at mma's n = 8: up to 8
// rows of x are one B operand of the decode kernel, which then reads each
// weight byte once; from 9 rows on, the decode kernel would need a second
// pass over the weights, while a 128-row wgmma tile reads each weight
// byte once for up to 128 rows (M = 9-16 is timed in chip_smoke's kernel
// phase).
// - int8_gemv_kernel (M <= 8, bf16): the weight rows are the tensor cores'
//   A operand and x's rows their n = 8 B operand (y^T = Wq . x^T), with
//   mma.sync m16n8k16. A block owns 64 output columns of the group and a
//   range of K; each of its 8 warps takes 16 columns and one 64-wide half
//   of every stage, the halves added in a fixed order at the end. Its
//   weights and x's rows flow through a ring of 8 stages of 128 K in shared
//   memory (cp.async, 16 bytes a copy: 8 KB of weights a stage, up to 56 KB
//   in flight a block, 2 blocks an SM). Each
//   64-wide chunk of K is permuted alike on both sides (mma step s,
//   fragment column 2t + j of lane quad t takes K offset 16 t + 4 s + j,
//   and 2t + 8 + j takes 16 t + 4 s + 2 + j), which puts a lane's own 16
//   contiguous bytes of shared memory in its fragments. int8 widens to
//   bf16 without I2F (widen4_bf16). Where the group's column blocks leave
//   SMs idle (q/k/v, o, down), K is split across blocks.
// - int8_wgmma_kernel<BN> (M > 8, bf16): 128 x BN output tiles (BN = 128
//   or 256, by plan() below), two consumer warpgroups of 64 rows, K in
//   steps of 64, wgmma.mma_async with A and B from shared memory (both
//   K-major) and f32 accumulators. A ring of 8 stages (BN = 128) or 5
//   (256), 225 KB either way, is fed by the TMA: one thread asks for each
//   step's x box (bf16, landing 128-byte swizzled, the layout wgmma reads)
//   and int8 weight box (plain 64-byte rows) against the slot's mbarrier,
//   out-of-range rows and columns arriving as zeros. While the tensor
//   cores run step k, the 256 threads widen step k + 1's int8 tile to bf16
//   (byte permutes, no I2F) into one of two swizzled bf16 tiles, so the
//   widened weights live only in shared memory. The epilogue scales each
//   accumulator column, rounds to bf16 once and stores the tile through
//   shared memory with 16-byte coalesced writes. Consecutive blocks walk
//   the N tiles of one x slab, which L2 keeps. Where the tiles do not fill
//   the card (M = 256: o, down, q/k/v), K is split across blocks. The
//   widening runs on the warps that issue the products, between their
//   barriers; the weights as wgmma's register A operand (widened in
//   registers, no bf16 tile) or a dedicated producer warpgroup are the
//   next levers (PERF.md).
// - int8_fma_kernel (f32, any M): 64 x 64 tiles on the CUDA cores, each
//   thread a 4 x 4 register tile, x and the widened weights as f32 in
//   shared memory; it serves the f32 parity configurations, which no
//   serving path runs. A group launches it once per member.
//
// Split K (both bf16 kernels): the blocks of one output tile (one K range
// each; 2 or 4, by plan() below) form one thread block cluster. Each puts its f32 partial in
// its own shared memory; after a cluster barrier they sum the partials in
// rank order through distributed shared memory (the decode kernel's rank
// 0 all of them, the prefill kernel's ranks a share of the rows each),
// scale and round, and a second barrier keeps every partial alive until
// it is read. The sum order is fixed, nothing goes through global memory,
// there are no atomics, and two calls give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <atomic>

#include "hopper_wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using hopper::opt_in_smem;

constexpr int MAX_MEMBERS = 4;

// the launches the card has run: block (0, 0, 0) of each launch adds one
// (read by polyaxon_int8_device_launches; a count that no host-side trace
// can drop)
__device__ unsigned long long g_device_launches = 0;

__device__ __forceinline__ void count_device_launch() {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    atomicAdd(&g_device_launches, 1ull);
  }
}
constexpr int MAX_SPLITS = 4;  // K splits of a tile: the blocks of one cluster

// The projections of one launch: up to four (Wq, scale, y) sets sharing x
// and K. Their output tiles are numbered one after another, member 0's
// first; tile_end[i] is one past member i's last tile (unused members
// repeat the last used end).
struct Group {
  const int8_t* w[MAX_MEMBERS];
  const float* scale[MAX_MEMBERS];
  void* y[MAX_MEMBERS];
  long long ldy[MAX_MEMBERS];
  int N[MAX_MEMBERS];
  int tile_end[MAX_MEMBERS];
};

struct Member {
  const int8_t* w;
  const float* scale;
  void* y;
  long long ldy;
  int N;
  int n0;  // the member's first column in this tile
  int i;   // which member
};

// the member owning output tile `tile` (constant indices only, so the
// parameter block stays in the constant bank)
template <int TILE_N>
__device__ __forceinline__ Member member_of(const Group& g, int tile) {
  const int i = (tile >= g.tile_end[0]) + (tile >= g.tile_end[1]) + (tile >= g.tile_end[2]);
#define POLYAXON_PICK(a) (i == 0 ? (a)[0] : i == 1 ? (a)[1] : i == 2 ? (a)[2] : (a)[3])
  const int first = i == 0 ? 0 : i == 1 ? g.tile_end[0] : i == 2 ? g.tile_end[1] : g.tile_end[2];
  Member m{POLYAXON_PICK(g.w), POLYAXON_PICK(g.scale), POLYAXON_PICK(g.y),
           POLYAXON_PICK(g.ldy), POLYAXON_PICK(g.N), (tile - first) * TILE_N, i};
#undef POLYAXON_PICK
  return m;
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// four int8 (one word) → two bf16x2 words: bytes 0,1 and bytes 2,3. A
// byte b + 128 sits in the mantissa of 2^23 (one byte_perm), one FADD
// removes 2^23 + 128, and the integer's bf16 is the f32's upper half
// (exact for |b| <= 128)
__device__ __forceinline__ void widen4_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128, unsigned
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // bytes [u_i, 0, 0, 0x4B]: the f32 2^23 + u_i
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | i)) - 8388736.0f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632u);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632u);
}

// ------------------------------------------------ prefill: M > 8, bf16, wgmma
constexpr int PF_BM = 128;  // rows of x a block: two warpgroups of 64
constexpr int PF_BK = 64;   // K a step: one 128-byte swizzled bf16 row
constexpr int PF_THREADS = 2 * hopper::WG;
using PfA = hopper::SwizzledTile<PF_BK, PF_BM>;  // x, [128][64] bf16

// BN output columns a block (wgmma's N), STAGES deep rings
template <int BN> struct Pf {
  static constexpr int STAGES = BN == 128 ? 8 : 5;  // 225 KB of shared memory either way
  using B = hopper::SwizzledTile<PF_BK, BN>;  // widened weights, [BN][64] bf16
  static constexpr int RAW_BYTES = BN * PF_BK;  // int8 weights, [BN][64] bytes
  static constexpr int C_LD = BN + 8;           // epilogue tile row, bf16 (padded)
  static constexpr uint32_t RAW_OFF = STAGES * PfA::BYTES;
  static constexpr uint32_t WIDE_OFF = RAW_OFF + STAGES * RAW_BYTES;
  static constexpr uint32_t BAR_OFF = WIDE_OFF + 2 * B::BYTES;  // a ring slot's mbarrier
  // the x ring, the int8 ring, two widened stages, the barriers; 1 KB to align
  static constexpr size_t SMEM = BAR_OFF + 8 * STAGES + 1024;
  static_assert(PF_BM * C_LD * 2 <= WIDE_OFF, "the epilogue tile fits the rings");
  static_assert(PF_BM * BN * 4 <= WIDE_OFF, "a split's f32 partial tile fits the rings");
  static_assert(SMEM <= 232448, "within a block's 227 KB of shared memory");
};

// The TMA's view of one launch: x [M, K] bf16 in boxes of 128 rows x 64
// (landing in the 128-byte swizzled layout wgmma reads), and each
// member's weights [N, K] int8 in boxes of BN rows x 64 bytes (plain rows).
// Boxes past M, N or K arrive zero-filled.
struct TmaMaps {
  CUtensorMap x;
  CUtensorMap w[MAX_MEMBERS];
};

// int8 [BN][64] → bf16 [BN][64] in the swizzled K-major layout: each
// thread widens 16-byte pieces of rows into two 16-byte bf16 chunks
template <int BN>
__device__ __forceinline__ void pf_widen(const uint8_t* raw, uint8_t* wide, int tid) {
#pragma unroll
  for (int q = 0; q < BN * (PF_BK / 16) / PF_THREADS; ++q) {
    const int i = tid + q * PF_THREADS, r = i / (PF_BK / 16), c = (i % (PF_BK / 16)) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * PF_BK + c);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) widen4_bf16(words[j], h[2 * j], h[2 * j + 1]);
    *reinterpret_cast<uint4*>(wide + Pf<BN>::B::offset(r, c)) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(wide + Pf<BN>::B::offset(r, c + 8)) =
        make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// grid: (BN-wide output tiles of the group, M tiles, K splits)
template <int BN>
__global__ void __launch_bounds__(PF_THREADS, 1)
int8_wgmma_kernel(const __grid_constant__ TmaMaps maps, const Group g, int M, int K,
                  int splits) {
  count_device_launch();
  using P = Pf<BN>;
  constexpr int S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_u32 = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw_u32 + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw_u32);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31, wwarp = (tid >> 5) & 3;
  const int tile = blockIdx.x;
  const Member mb = member_of<BN>(g, tile);
  const int m0 = blockIdx.y * PF_BM;
  const int steps = (K + PF_BK - 1) / PF_BK;
  const int kt0 = (int)((long long)steps * blockIdx.z / splits);
  const int nk = (int)((long long)steps * (blockIdx.z + 1) / splits) - kt0;

  const uint32_t bars = base + P::BAR_OFF;
  const CUtensorMap* wmap = &maps.w[0] + mb.i;
  // thread 0 asks the TMA for step kt of this split (its x and int8 tiles)
  // into ring slot kt % S, announcing the bytes to the slot's barrier
  auto load = [&](int kt) {
    const int slot = kt % S, k0 = (kt0 + kt) * PF_BK;
    const uint32_t bar = bars + 8 * slot;
    hopper::mbar_expect_tx(bar, PfA::BYTES + P::RAW_BYTES);
    hopper::tma_load_2d(base + slot * PfA::BYTES, &maps.x, bar, k0, m0);
    hopper::tma_load_2d(base + P::RAW_OFF + slot * P::RAW_BYTES, wmap, bar, k0, mb.n0);
  };
  // step kt has landed: the (kt / S)-th fill of its slot
  auto landed = [&](int kt) { hopper::mbar_wait(bars + 8 * (kt % S), (kt / S) & 1); };
  auto widen = [&](int kt) {
    pf_widen<BN>(base_ptr + P::RAW_OFF + (kt % S) * P::RAW_BYTES,
                 base_ptr + P::WIDE_OFF + (kt & 1) * P::B::BYTES, tid);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) hopper::mbar_init(bars + 8 * s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int kt = 0; kt < S - 1 && kt < nk; ++kt) load(kt);
  }
  landed(0);
  widen(0);
  hopper::fence_proxy_async();
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    // this warpgroup's 64 rows of x, and the widened weights of step kt
    const uint32_t sA = base + (kt % S) * PfA::BYTES + wg * 64 * PfA::ROW_BYTES;
    const uint32_t sB = base + P::WIDE_OFF + (kt & 1) * P::B::BYTES;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_BK / 16; ++kk)
      hopper::WgmmaSS<BN>::run(acc, PfA::k_major(sA, kk), P::B::k_major(sB, kk), 1);
    hopper::wgmma_commit();
    // while it runs: step kt - 1's products are done (its x slot and widened
    // stage are free once every warpgroup is past this wait's barrier),
    // and step kt + 1 has landed
    hopper::wgmma_wait<1>();
    if (kt + 1 < nk) landed(kt + 1);
    __syncthreads();
    if (kt + 1 < nk) widen(kt + 1);  // into step kt - 1's widened stage
    hopper::fence_proxy_async();
    if (tid == 0 && kt + S - 1 < nk) load(kt + S - 1);  // into step kt - 1's slot
    __syncthreads();
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // accumulator register 4j + e: row 64 wg + 16 wwarp + lane / 4 + 8 (e / 2)
  // of the tile, column 8j + 2 (lane % 4) + e % 2
  const int r_base = wg * 64 + wwarp * 16 + (lane >> 2);
  const int c_base = 2 * (lane & 3);
  __syncthreads();  // every warpgroup's products are done: the rings are free
  bf16* y = static_cast<bf16*>(mb.y);
  // 16-byte stores where the member's rows start on 16-byte boundaries
  const bool vec = (mb.ldy & 7) == 0 && (reinterpret_cast<uintptr_t>(mb.y) & 15) == 0;
  if (splits > 1) {
    // split K over the blocks of one cluster (blockIdx.z = cluster rank):
    // each puts its f32 partial tile in its own shared memory, then sums
    // its share of the rows over all ranks' partials in rank order
    cg::cluster_group cluster = cg::this_cluster();
    float* part = reinterpret_cast<float*>(base_ptr);  // [128][BN], 8-column chunks XOR-ed by row
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + 8 * h, c = 8 * j + c_base;
        *reinterpret_cast<float2*>(part + r * BN + (c ^ ((r & 7) << 3))) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    cluster.sync();
    const int rank = blockIdx.z;
    const int r0 = PF_BM * rank / splits, r1 = PF_BM * (rank + 1) / splits;
    for (int i = tid; i < (r1 - r0) * (BN / 8); i += PF_THREADS) {
      const int r = r0 + i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int row = m0 + r, n = mb.n0 + c;
      if (row >= M || n >= mb.N) continue;
      const int off = r * BN + (c ^ ((r & 7) << 3));
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < splits; ++q) {
        const float* src = cluster.map_shared_rank(part, q) + off;
        const float4 lo = *reinterpret_cast<const float4*>(src);
        const float4 hi = *reinterpret_cast<const float4*>(src + 4);
        v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
        v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
      }
      uint32_t packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s0 = n + 2 * e < mb.N ? __ldg(mb.scale + n + 2 * e) : 0.f;
        const float s1 = n + 2 * e + 1 < mb.N ? __ldg(mb.scale + n + 2 * e + 1) : 0.f;
        packed[e] = hopper::pack_bf16(v[2 * e] * s0, v[2 * e + 1] * s1);
      }
      bf16* dst = y + (long long)row * mb.ldy + n;
      if (vec && n + 8 <= mb.N) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(packed);
        for (int u = 0; u < 8 && n + u < mb.N; ++u) dst[u] = e[u];
      }
    }
    cluster.sync();  // no block leaves while another reads its partial
    return;
  }
  bf16* C = reinterpret_cast<bf16*>(base_ptr);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + c_base, n = mb.n0 + col;
    const float s0 = n < mb.N ? __ldg(mb.scale + n) : 0.f;
    const float s1 = n + 1 < mb.N ? __ldg(mb.scale + n + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<__nv_bfloat162*>(&C[(r_base + 8 * h) * P::C_LD + col]) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * s0, acc[4 * j + 2 * h + 1] * s1);
    }
  }
  __syncthreads();
  for (int i = tid; i < PF_BM * (BN / 8); i += PF_THREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int row = m0 + r, n = mb.n0 + c;
    if (row >= M || n >= mb.N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(&C[r * P::C_LD + c]);
    bf16* dst = y + (long long)row * mb.ldy + n;
    if (vec && n + 8 <= mb.N) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      for (int u = 0; u < 8 && n + u < mb.N; ++u) dst[u] = e[u];
    }
  }
}

// ------------------------------------------------- decode: M <= 8, bf16
constexpr int GV_MMAX = 8;                   // rows of x it takes (mma's n = 8)
constexpr int GV_COLS = 64;                  // output columns a block: 4 groups of mma's 16 rows
constexpr int GV_SK = 128;                   // K a stage: two 64-wide mma chunks
constexpr int GV_WARPS = (GV_COLS / 16) * (GV_SK / 64);  // a warp: one row group, one chunk
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_STAGES = 8;                 // 81 KB: 2 blocks an SM
constexpr int GV_W_BYTES = GV_COLS * GV_SK;  // [64][128] int8, 16-byte units XOR-ed by row
constexpr int GV_X_LD = 2 * GV_SK + 16;      // bytes an x row (padded)
constexpr int GV_STAGE_BYTES = GV_W_BYTES + GV_MMAX * GV_X_LD;
constexpr size_t GV_SMEM = GV_STAGES * GV_STAGE_BYTES;

// byte offset of the 16-byte unit u of weight row r in a stage: odd rows
// swap the two halves of their 128 bytes, so the two rows a quarter-warp
// reads at once fall on disjoint banks
__device__ __forceinline__ int gv_w_offset(int r, int u) {
  return r * GV_SK + ((u ^ ((r & 1) << 2)) << 4);
}

// grid: (64-column tiles of the group, K splits)
__global__ void __launch_bounds__(GV_THREADS)
int8_gemv_kernel(const bf16* __restrict__ x, long long ldx, const Group g, int M, int K,
                 int splits) {
  count_device_launch();
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x;
  const Member mb = member_of<GV_COLS>(g, tile);
  const int stages = (K + GV_SK - 1) / GV_SK;
  const int st0 = stages * blockIdx.y / splits;
  const int ns = stages * (blockIdx.y + 1) / splits - st0;
  const uint32_t sm = hopper::smem_u32(smem);

  auto load = [&](int st) {  // stage st of this split: 64 weight rows, M rows of x
    const uint32_t sw = sm + (st % GV_STAGES) * GV_STAGE_BYTES, sx = sw + GV_W_BYTES;
    const int k0 = (st0 + st) * GV_SK;
#pragma unroll
    for (int q = 0; q < GV_COLS * (GV_SK / 16) / GV_THREADS; ++q) {
      const int i = tid + q * GV_THREADS, r = i / (GV_SK / 16), u = i % (GV_SK / 16);
      const bool live = mb.n0 + r < mb.N && k0 + 16 * u < K;
      hopper::cp_async16(sw + gv_w_offset(r, u),
                         live ? mb.w + (long long)(mb.n0 + r) * K + k0 + 16 * u : mb.w,
                         live ? 16 : 0);
    }
    if (tid < M * (GV_SK / 8)) {
      const int r = tid / (GV_SK / 8), c = (tid % (GV_SK / 8)) * 8;
      const bool live = k0 + c < K;
      hopper::cp_async16(sx + r * GV_X_LD + 2 * c, live ? x + (long long)r * ldx + k0 + c : x,
                         live ? 16 : 0);
    }
  };

  for (int st = 0; st < GV_STAGES - 1; ++st) {
    if (st < ns) load(st);
    hopper::cp_async_commit();
  }
  // this warp's 16 weight rows (mma's rows g and g + 8) and its 64-wide
  // chunk of every stage
  const int rg = warp % (GV_COLS / 16), c = warp / (GV_COLS / 16);
  const int r0 = 16 * rg + gq, r1 = r0 + 8;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int st = 0; st < ns; ++st) {
    hopper::cp_async_wait<GV_STAGES - 2>();  // stage st has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; every warp is done with stage st - 1
    if (st + GV_STAGES - 1 < ns) load(st + GV_STAGES - 1);  // into stage st - 1's slot
    hopper::cp_async_commit();
    const uint8_t* sw = smem + (st % GV_STAGES) * GV_STAGE_BYTES;
    const uint8_t* sx = sw + GV_W_BYTES;
    {
      const int u = 4 * c + t;  // this lane's 16 K values of the chunk: unit u
      const uint4 w0 = *reinterpret_cast<const uint4*>(sw + gv_w_offset(r0, u));
      const uint4 w1 = *reinterpret_cast<const uint4*>(sw + gv_w_offset(r1, u));
      uint4 xv[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (gq < M) {
        xv[0] = *reinterpret_cast<const uint4*>(sx + gq * GV_X_LD + 32 * u);
        xv[1] = *reinterpret_cast<const uint4*>(sx + gq * GV_X_LD + 32 * u + 16);
      }
      const uint32_t wa[4] = {w0.x, w0.y, w0.z, w0.w};
      const uint32_t wb[4] = {w1.x, w1.y, w1.z, w1.w};
      const uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                              xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4], b[2];
        widen4_bf16(wa[s], a[0], a[2]);
        widen4_bf16(wb[s], a[1], a[3]);
        b[0] = xw[2 * s];
        b[1] = xw[2 * s + 1];
        mma_bf16_16816(acc, a, b);
      }
    }
  }
  // the two chunks' partials of each (column, x row), added in chunk
  // order; accumulator register e sits at (weight row g + 8 (e / 2), x
  // row 2t + e % 2) of the warp's 16 rows
  __shared__ float part[GV_SK / 64][GV_COLS][GV_MMAX];
#pragma unroll
  for (int e = 0; e < 4; ++e) part[c][16 * rg + gq + 8 * (e >> 1)][2 * t + (e & 1)] = acc[e];
  __syncthreads();
  constexpr int PER = GV_COLS * GV_MMAX / GV_THREADS;  // (column, row) pairs a thread
  float* flat = &part[0][0][0];
  float total[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * GV_THREADS;
    total[j] = flat[i] + flat[GV_COLS * GV_MMAX + i];
  }
  bf16* y = static_cast<bf16*>(mb.y);
  if (splits > 1) {
    // split K over the blocks of one cluster (blockIdx.y = cluster rank):
    // each leaves its total in its own shared memory; rank 0 sums them in
    // rank order
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int j = 0; j < PER; ++j) flat[tid + j * GV_THREADS] = total[j];  // each its own slot
    cluster.sync();
    if (blockIdx.y == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int i = tid + j * GV_THREADS;
        total[j] = 0.f;
        for (int q = 0; q < splits; ++q) total[j] += cluster.map_shared_rank(flat, q)[i];
      }
    }
    cluster.sync();  // no block leaves while rank 0 reads its partial
    if (blockIdx.y != 0) return;
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + j * GV_THREADS, m = i % GV_MMAX, n = mb.n0 + i / GV_MMAX;
    if (m < M && n < mb.N) {
      y[(long long)m * mb.ldy + n] = __float2bfloat16(total[j] * __ldg(mb.scale + n));
    }
  }
}

// ------------------------------------------------------ large M, f32 FMA
constexpr int BM = 64, BN = 64;
constexpr int FBK = 16, FPAD = 4, FMA_THREADS = 256;

__global__ void __launch_bounds__(FMA_THREADS)
int8_fma_kernel(const float* __restrict__ x, long long ldx,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                float* __restrict__ y, long long ldy, int M, int N, int K) {
  count_device_launch();
  __shared__ __align__(16) float As[FBK][BM + FPAD];
  __shared__ __align__(16) float Bs[FBK][BN + FPAD];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ld_row = tid >> 2, ld_col = (tid & 3) * 4;  // 64 rows x 4 chunks of 4
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    {
      const int gm = m0 + ld_row, gk = k0 + ld_col;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M && gk < K) v = *reinterpret_cast<const float4*>(x + (long long)gm * ldx + gk);
      As[ld_col][ld_row] = v.x;
      As[ld_col + 1][ld_row] = v.y;
      As[ld_col + 2][ld_row] = v.z;
      As[ld_col + 3][ld_row] = v.w;
    }
    {
      const int gn = n0 + ld_row, gk = k0 + ld_col;
      int word = 0;
      if (gn < N && gk < K) word = __ldg(reinterpret_cast<const int*>(w + (long long)gn * K + gk));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Bs[ld_col + j][ld_row] = static_cast<float>(static_cast<int8_t>((word >> (8 * j)) & 0xff));
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) y[(long long)row * ldy + col] = acc[i][j] * scale[col];
    }
  }
}

// the group's tiles of `tile_n` columns; false if a member is empty
bool number_tiles(Group& g, int members, int tile_n, int* total) {
  int end = 0;
  for (int i = 0; i < MAX_MEMBERS; ++i) {
    if (i < members) {
      if (g.N[i] <= 0 || g.N[i] > g.ldy[i] || !g.w[i] || !g.scale[i] || !g.y[i]) return false;
      end += (g.N[i] + tile_n - 1) / tile_n;
    }
    g.tile_end[i] = end;
  }
  *total = end;
  return true;
}

// a launch whose K splits (grid dimension `split_dim`, 1 = y, 2 = z) form
// one thread block cluster, so their partials meet in distributed shared
// memory
template <typename... Args>
cudaError_t launch_split(void (*kernel)(Args...), dim3 grid, int threads, size_t smem,
                         int split_dim, int splits, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split_dim == 1 ? splits : 1;
  attr[0].val.clusterDim.z = split_dim == 2 ? splits : 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] tensor with `row_bytes` between rows, read in
// boxes of box_rows x box_cols
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, long long cols,
               long long rows, long long row_bytes, int box_cols, int box_rows,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan of a bf16 launch: the prefill tile width (0 for the decode
// kernel) and the K splits, from the shapes and the card's SM count alone,
// so a call's sum order (and bits) never depend on timing. Decode splits
// K until its blocks fill the SMs once (llama3-1b on 132 SMs: q/k/v 2, o
// and down 4, gate/up 1). Prefill takes the tile width and split whose
// waves x steps a block x cost of a step is least, a split being allowed
// only while its blocks fit in one wave and each has at least 4 steps of
// K. The costs were fitted to one H100's times of every plan at
// llama3-1b's shapes: a step of a 256-wide tile costs 1.7x a 128-wide
// one's (in tenths below), and clusters of 2 and 4 blocks of 225 KB find
// room on about 0.9 and 0.5 of the SMs in one wave.
struct Plan {
  int tile_n;
  int splits;
};

Plan plan(int M, int K, const int* N, int members, int sms) {
  if (M <= GV_MMAX) {
    int tiles = 0;
    for (int i = 0; i < members; ++i) tiles += (N[i] + GV_COLS - 1) / GV_COLS;
    const int stages = (K + GV_SK - 1) / GV_SK;
    int splits = sms / (tiles > 0 ? tiles : 1);
    splits = splits < stages ? splits : stages;
    splits = splits < MAX_SPLITS ? splits : MAX_SPLITS;
    return {0, splits > 1 ? splits : 1};
  }
  constexpr int kWidth[2] = {256, 128}, kCost[2] = {17, 10};
  constexpr int kSplits[3] = {1, 2, 4}, kFill[3] = {10, 9, 5};
  const int steps = (K + PF_BK - 1) / PF_BK;
  const int m_tiles = (M + PF_BM - 1) / PF_BM;
  Plan best{0, 1};
  long long best_est = -1;
  for (int w = 0; w < 2; ++w) {
    int tiles = 0;
    for (int i = 0; i < members; ++i) tiles += (N[i] + kWidth[w] - 1) / kWidth[w];
    tiles *= m_tiles;
    for (int j = 0; j < 3; ++j) {
      const int sp = kSplits[j];
      if (sp > 1 && (tiles * sp > sms || steps < 4 * sp)) break;
      const int slots = sms * kFill[j] / 10;
      const long long waves = (tiles * sp + slots - 1) / slots;
      const long long est = waves * ((steps + sp - 1) / sp) * kCost[w];
      if (best_est < 0 || est < best_est) {
        best_est = est;
        best = {kWidth[w], sp};
      }
    }
  }
  return best;
}

// the current device's SM count, looked up once a device
int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && (sms = cached[dev].load(std::memory_order_relaxed)) > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cached[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

template <int BN>
cudaError_t launch_prefill(const bf16* x, long long ldx, const Group& g, int members, int tiles,
                           int m_tiles, int M, int K, int splits, cudaStream_t s) {
  TmaMaps maps{};
  if (!encode_2d(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, ldx * 2, PF_BK, PF_BM,
                 CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < members; ++i) {
    if (!encode_2d(&maps.w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, g.w[i], K, g.N[i], K, PF_BK, BN,
                   CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return cudaErrorInvalidValue;
    }
  }
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t err = opt_in_smem(int8_wgmma_kernel<BN>, Pf<BN>::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, m_tiles, splits);
  if (splits == 1) {
    int8_wgmma_kernel<BN><<<grid, PF_THREADS, Pf<BN>::SMEM, s>>>(maps, g, M, K, splits);
  } else {
    err = launch_split(int8_wgmma_kernel<BN>, grid, PF_THREADS, Pf<BN>::SMEM, 2, splits, s, maps,
                       g, M, K, splits);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

// The plan (tile width, K splits) that polyaxon_int8_matmul takes for
// these shapes on the current device: (0, 1) for f32, (0, s) for the
// decode kernel. Returns 0, or a cudaError if the device is not readable.
extern "C" int polyaxon_int8_plan(int dtype, int M, int K, int members, int N0, int N1, int N2,
                                  int N3, int* tile_n, int* splits) {
  const int N[MAX_MEMBERS] = {N0, N1, N2, N3};
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  if (members < 1 || members > MAX_MEMBERS) return (int)cudaErrorInvalidValue;
  const Plan p = dtype == 1 ? plan(M, K, N, members, sms) : Plan{0, 1};
  *tile_n = p.tile_n;
  *splits = p.splits;
  return 0;
}

// The kernel launches the current device has run since the library was
// loaded (int8_fma_kernel counts once a member). Returns a cudaError.
extern "C" int polyaxon_int8_device_launches(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_device_launches, sizeof(*out));
}

// One launch for x [M, K] against `members` (1-4) sets (w_i int8 [N_i, K],
// s_i f32 [N_i], y_i [M, N_i] with row stride ldy). dtype: 0 = float32, 1 = bfloat16 (x
// and y). bf16 takes int8_gemv_kernel for M <= 8 (64-column tiles) and
// int8_wgmma_kernel above (128 or 256 columns a tile), both over the whole
// group in one grid, with K split by plan() (the splits of a tile form one
// cluster); f32 takes int8_fma_kernel once per member. Returns
// cudaGetLastError() after the launches (0 on success); invalid arguments
// return cudaErrorInvalidValue unlaunched.
extern "C" int polyaxon_int8_matmul(
    const void* x, int dtype, int M, int K, long long ldx, int members,
    const void* w0, const void* w1, const void* w2, const void* w3,
    const void* s0, const void* s1, const void* s2, const void* s3,
    void* y0, void* y1, void* y2, void* y3,
    int N0, int N1, int N2, int N3, long long ldy, void* stream) {
  if (M <= 0 || K <= 0 || K % 16 != 0 || (dtype != 0 && dtype != 1) || members < 1 ||
      members > MAX_MEMBERS || !x || ldy <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Group g{{static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1),
           static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3)},
          {static_cast<const float*>(s0), static_cast<const float*>(s1),
           static_cast<const float*>(s2), static_cast<const float*>(s3)},
          {y0, y1, y2, y3},
          {ldy, ldy, ldy, ldy},
          {N0, N1, N2, N3},
          {0, 0, 0, 0}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int tiles = 0;
  if (dtype == 0) {
    if (!number_tiles(g, members, BN, &tiles) || (M + BM - 1) / BM > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    for (int i = 0; i < members; ++i) {
      const dim3 grid((g.N[i] + BN - 1) / BN, (M + BM - 1) / BM);
      int8_fma_kernel<<<grid, FMA_THREADS, 0, s>>>(
          static_cast<const float*>(x), ldx, g.w[i], g.scale[i], static_cast<float*>(g.y[i]),
          g.ldy[i], M, g.N[i], K);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  const bf16* xb = static_cast<const bf16*>(x);
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Plan p = plan(M, K, g.N, members, sms);
  const int splits = p.splits;
  if (M <= GV_MMAX) {
    if (!number_tiles(g, members, GV_COLS, &tiles)) {
      return (int)cudaErrorInvalidValue;
    }
    static std::atomic<unsigned long long> smem_set{0};
    cudaError_t err = opt_in_smem(int8_gemv_kernel, GV_SMEM, smem_set);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(tiles, splits);
    if (splits == 1) {
      int8_gemv_kernel<<<grid, GV_THREADS, GV_SMEM, s>>>(xb, ldx, g, M, K, splits);
    } else {
      err = launch_split(int8_gemv_kernel, grid, GV_THREADS, GV_SMEM, 1, splits, s, xb, ldx, g, M,
                         K, splits);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  }
  const int m_tiles = (M + PF_BM - 1) / PF_BM;
  if (!number_tiles(g, members, p.tile_n, &tiles) || m_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)(p.tile_n == 128
                   ? launch_prefill<128>(xb, ldx, g, members, tiles, m_tiles, M, K, splits, s)
                   : launch_prefill<256>(xb, ldx, g, members, tiles, m_tiles, M, K, splits, s));
}
