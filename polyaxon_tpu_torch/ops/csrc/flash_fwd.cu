// Flash-attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma), f32 on the CUDA cores (scalar FMA).
//
// Replaces: polyaxon_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd through pl.pallas_call). It computes the same function:
// blockwise online-softmax attention with f32 scores and accumulators,
// causal tiles above the diagonal skipped, grouped-query attention by
// mapping query head h onto kv head h / group (the order of jnp.repeat and
// of the decode branch's h = kv * G + g), p rounded to the value dtype
// before P.V, and outputs o plus lse = m + log(max(l, 1e-30)).
//
// What bounds it: at the main-path shape (B=1, S=4096, H=32, KV=8, D=64,
// bf16, causal) the work is 4*B*H*pairs*D = 68.7 GFLOP against 42 MB of
// inputs and outputs, about 1600 operations per byte, far above the
// card's ~295 bf16 operations per byte: the kernel is compute-bound, 0.069
// ms at the tensor cores' 989 TFLOP/s against ~1 ms at the CUDA cores' 67
// TFLOP/s f32. Beside the products, every score takes one exp2 on the
// SMs' special-function units (16 a clock per SM): at D = 64 a 64 x 64
// tile's 4096 exponentials take as many clocks as its two products on the
// tensor cores, so the softmax is not free either.
//
// What the bf16 design does about it (flash_fwd_wgmma_kernel): one
// warpgroup (128 threads) per block owns a 64-row q tile and loops over the
// live 64-key tiles, running both products as wgmma.mma_async with bf16
// operands and f32 accumulators:
// - S = Q.K^T with A and B from shared memory, both K-major;
// - the online softmax in the accumulator registers: scores scaled into the
//   log2 domain (log2(e) folded into the scale, so p = exp2(x - m)), the row
//   max reduced over the 4 lanes that share a row, alpha = exp2(m_old -
//   m_new) rescaling l and the output accumulator, l summed from the f32 p
//   before rounding (each lane keeps its own columns' share; the 4 shares
//   are added once, at the end);
// - O += P.V with p rounded to bf16 (the reference's p.astype(v.dtype)) in
//   registers: the f32 fragment of S, packed in bf16 pairs, is wgmma's A
//   fragment, so P never touches shared memory; V is the MN-major B operand.
// Operands are staged as bf16 in the swizzled layout wgmma's descriptors
// read (hopper_wgmma.cuh: 128-byte swizzle for D = 64 and 128, 64-byte for
// 32) by cp.async with zero-fill past S: Q once, K and V through a ring of
// two stages, so the next kv tile loads while wgmma runs on this one. No
// scalar product touches bf16 data. Only diagonal and ragged (past S)
// tiles pay for the masks.
//
// Budget per warpgroup (ptxas -v for sm_90a, see `<lib>.log` beside the
// built library; bytes of dynamic shared memory from the code): Q plus two
// stages of K and V, 5 x 64 x D x 2 bytes + 1 KB for alignment: 21, 41
// and 81 KB for D = 32, 64, 128; accumulators S (32 f32) and O (D / 2) per
// thread, P packed in 16 registers. ptxas -v reports 79 / 127 / 167
// registers per thread for D = 32 / 64 / 128 and no spills, so 6, 4 and 2
// blocks fit on an SM (registers bound the first two, shared memory the
// third). chip_smoke.py prints the report of every build.
//
// Issuing the next tile's Q.K^T with this tile's P.V, so that the softmax
// runs while P.V is on the tensor cores (FA3's overlap inside one
// warpgroup), was measured slower on an H100 (PERF.md): P lives across the
// loop, 158 registers at D = 64 leave 3 blocks per SM instead of 4, and
// capping it at 4 blocks only brings it back to this kernel's time.
//
// f32 inputs keep the scalar-FMA kernel (flash_fwd_kernel): 64 x 64 tiles
// staged as f32 in shared memory, each thread a 4 x 4 register tile of the
// score matrix, P through shared memory. It serves f32 programs and the f32
// gradient checks; the dispatch below is by dtype, and neither path stands
// in for the other.
//
// Work split: one block owns one (batch*head, 64-row q tile); the TPU
// grid's sequential kv dimension is the loop inside the block. The bf16
// kernel issues the q tiles with the most causal work first; fully masked
// causal kv tiles are never loaded. No atomics: repeated runs give the
// same bits.
// Layout: q [B,S,H,D] and k/v [B,S,KV,D] are read by stride (last dim
// contiguous; the bf16 kernel needs 16-byte aligned rows, which the wrapper
// checks), so no transposed copy is made; o is written [B,S,H,D]
// contiguous and lse [B,H,S] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int CPT = BKV / 16; // keys per thread
constexpr int PP = BKV + 1;   // padded row of the P tile
constexpr float NEG_INF = -1e30f;  // the TPU kernel's causal mask value

using hopper::LN2;
using hopper::LOG2E;
using hopper::opt_in_smem;
using hopper::WG;
using bf16 = __nv_bfloat16;

// The scalar kernel is instantiated for float only (bf16 runs on the wgmma
// kernel); the conversions keep their dtype-generic form.
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  // Q [BQ][D+1], K [BKV][D+1], V [BKV][D], P [BQ][BKV+1], all f32
  return sizeof(float) * (BQ * (D + 1) + BKV * (D + 1) + BKV * D + BQ * PP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int group,
                 long long sq_b, long long sq_s, long long sq_h,
                 long long sk_b, long long sk_s, long long sk_h,
                 long long sv_b, long long sv_s, long long sv_h,
                 float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;  // odd row stride: the 16 keys a half-warp
                             // reads sit on 16 distinct banks
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BKV * DP;
  float* Ps = Vs + BKV * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column lane
  const int ty = tid >> 4;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;

  const T* qb = q + b * sq_b + h * sq_h;
  const T* kb = k + b * sk_b + kvh * sk_h;
  const T* vb = v + b * sv_b + kvh * sv_h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = q0 + r;
    Qs[r * DP + c] = s < S ? to_f32<T>(qb[s * sq_s + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // causal: tiles starting past the q tile's last row are fully masked
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Qs written / previous tile's K, V, P reads done
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int s = k0 + r;
      const bool ok = s < S;
      Ks[r * DP + c] = ok ? to_f32<T>(kb[s * sk_s + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32<T>(vb[s * sv_s + c]) : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (col >= S) {
          x = -INFINITY;  // past the sequence (S < BKV): no mass at all
        } else if (causal && col > row) {
          x = NEG_INF;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads sharing a row are 16 adjacent lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        // p.astype(v.dtype) before P.V, as the TPU kernel does
        Ps[(ty * RPT + i) * PP + tx + 16 * j] = to_f32<T>(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(ty * RPT + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < S) {
      const float ll = fmaxf(l[i], 1e-30f);
      T* orow = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c] / ll);
      if (tx == 0) lse[(long long)bh * S + row] = m[i] + logf(ll);
    }
  }
}

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q, then two stages of K and V, bf16 [64][D]; 1 KB to align
  return 5 * hopper::SwizzledTile<D>::BYTES + 1024;
}

// The forward for bf16 on the tensor cores: one warpgroup per (b*h, 64-row
// q tile), looping over the live kv tiles.
template <int D>
__global__ void __launch_bounds__(WG)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int S, int H, int group,
                       long long sq_b, long long sq_s, long long sq_h,
                       long long sk_b, long long sk_s, long long sk_h,
                       long long sv_b, long long sv_s, long long sv_h,
                       float scale, int causal) {
  using Tile = hopper::SwizzledTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  // stage s: K at base + (1 + 2s) * BYTES, V right after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const bf16* kb = k + b * sk_b + kvh * sk_h;
  const bf16* vb = v + b * sv_b + kvh * sv_h;

  // causal: kv tiles starting past the q tile's last row are fully masked
  const int n_kv = ((causal ? min(S, q0 + BQ) : S) + BKV - 1) / BKV;
  Tile::load(sQ, q + b * sq_b + h * sq_h, sq_s, q0, S, tid, WG);
  for (int it = 0; it < 2; ++it) {  // the ring's first two kv tiles
    if (it < n_kv) {
      const uint32_t sK = base + (1 + 2 * it) * Tile::BYTES;
      Tile::load(sK, kb, sk_s, it * BKV, S, tid, WG);
      Tile::load(sK + Tile::BYTES, vb, sv_s, it * BKV, S, tid, WG);
    }
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows: 16 * warp + lane / 4 and 8 below it;
  // m is the running max in the log2 domain, l this lane's share of the sum
  const int row_a = q0 + 16 * warp + (lane >> 2);
  const float scale_log2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * BKV;
    const uint32_t sK = base + (1 + 2 * (it & 1)) * Tile::BYTES, sV = sK + Tile::BYTES;
    hopper::cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hopper::fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(s, Tile::k_major(sQ, kk), Tile::k_major(sK, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // scores in the log2 domain; masked (no mass): the causal future
    // (-1e30 in the reference, exp -> 0) and keys past the sequence.
    // Register i holds row row_a + 8 * ((i >> 1) & 1), column
    // k0 + 8 * (i >> 2) + 2 * t + (i & 1).
    const bool edge = (causal && k0 + BKV - 1 > q0) || k0 + BKV > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      float val = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if ((causal && col > row_a + 8 * x) || col >= S) val = -INFINITY;
      }
      s[i] = val;
      mx[x] = fmaxf(mx[x], val);
    }
    float alpha[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      // the 4 lanes sharing a row differ in lane bits 0-1
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m[x], mx[x]);
      alpha[x] = exp2f(m[x] - m_new);
      m[x] = m_new;
    }

    // p = exp2(x - m), summed in f32 into l, then rounded to bf16 (v's
    // dtype) in the A fragment layout: register i/2 packs elements i, i+1
    uint32_t p[16];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int x = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - m[x]), p1 = exp2f(s[i + 1] - m[x]);
      rs[x] += p0 + p1;
      p[i / 2] = hopper::pack_bf16(p0, p1);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = alpha[x] * l[x] + rs[x];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    hopper::fence_regs(p);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hopper::WgmmaRsTransB<D>::run(acc, p + 4 * kk, Tile::mn_major(sV, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(p);

    __syncthreads();  // every warp is done with this stage: refill it
    if (it + 2 < n_kv) {
      Tile::load(sK, kb, sk_s, k0 + 2 * BKV, S, tid, WG);
      Tile::load(sV, vb, sv_s, k0 + 2 * BKV, S, tid, WG);
    }
    hopper::cp_async_commit();
  }

  // o = acc / max(l, 1e-30) with l summed over the row's 4 lanes; lse in
  // natural log, m converted from the log2 domain
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] = fmaxf(l[x], 1e-30f);
    const int row = row_a + 8 * x;
    if (t == 0 && row < S) lse[(long long)bh * S + row] = m[x] * LN2 + logf(l[x]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int x = (i >> 1) & 1;
    const int row = row_a + 8 * x;
    if (row < S) {
      bf16* out = o + (((long long)b * S + row) * H + h) * D + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out) =
          __floats2bfloat162_rn(acc[i] / l[x], acc[i + 1] / l[x]);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, S, H, KV;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_scalar(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_fwd_kernel<float, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H, a.H / a.KV, a.sq_b, a.sq_s, a.sq_h,
      a.sk_b, a.sk_s, a.sk_h, a.sv_b, a.sv_s, a.sv_h, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_fwd_wgmma_kernel<D>;
  const size_t smem = wgmma_smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H, a.H / a.KV, a.sq_b, a.sq_s, a.sq_h,
      a.sk_b, a.sk_s, a.sk_h, a.sv_b, a.sv_s, a.sv_h, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (the scalar-FMA kernel), 1 = bfloat16 (the wgmma
// kernel). Strides are in elements; the last dim of q, k and v must be
// contiguous. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int polyaxon_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int S, int H, int KV, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long sv_b, long long sv_s, long long sv_h,
    float scale, int causal, void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, B, S, H, KV,
               sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
               scale, causal, static_cast<cudaStream_t>(stream)};
#define POLYAXON_FLASH_FWD_CASE(DIM)                              \
  if (D == DIM) return (int)(dtype == 0 ? launch_scalar<DIM>(a) \
                                        : launch_wgmma<DIM>(a));
  if (dtype == 0 || dtype == 1) {
    POLYAXON_FLASH_FWD_CASE(32)
    POLYAXON_FLASH_FWD_CASE(64)
    POLYAXON_FLASH_FWD_CASE(128)
  }
#undef POLYAXON_FLASH_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
