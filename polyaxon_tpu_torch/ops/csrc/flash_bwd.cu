// Flash-attention backward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma), f32 on the CUDA cores (scalar FMA).
//
// Replaces: polyaxon_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (both launched by _bwd_impl through pl.pallas_call). Same function, the
// FlashAttention-2 recipe: p = exp(s - lse) is recomputed from the forward's
// logsumexp, ds = p * (dO.V^T - delta) * scale, then
//   dq  = ds . K                     (dq kernels)
//   dv  = p^T . dO,  dk = ds^T . Q   (dk/dv kernels, summed over the query
//                                     heads of each GQA group)
// with f32 scores and accumulators and the TPU kernels' rounding points:
// ds is rounded to k's dtype before ds.K, p to dO's dtype before p^T.dO and
// ds to q's dtype before ds^T.Q; outputs are written in the input dtype.
// `delta` (rowsum(dO * o), minus the lse cotangent where there is one) is
// computed outside, as the reference computes it outside its kernels.
//
// What bounds it: at the main-path shape (B=1, S=4096, H=32, KV=8, D=64,
// bf16, causal) dq does 3 products (6*B*H*pairs*D = 103 GFLOP) and dk/dv 4
// (138 GFLOP) against ~60 and ~51 MB of inputs and outputs: compute-bound,
// 0.104 and 0.139 ms at the tensor cores' 989 TFLOP/s, against 1.5 and
// 2.1 ms at the CUDA cores' 67 TFLOP/s f32.
//
// What the bf16 design does about it (flash_dq_wgmma_kernel,
// flash_dkv_wgmma_kernel): one warpgroup (128 threads) per block owns a
// 64-row output tile and runs every product as wgmma.mma_async with bf16
// operands and f32 accumulators:
// - dq: per kv tile, S = Q.K^T and dP = dO.V^T (A and B from shared memory,
//   K-major), ds = p * (dP - delta) * scale in the accumulator registers,
//   then dQ += ds.K with ds rounded to bf16 and fed as the A operand from
//   registers (an f32 accumulator fragment, packed in pairs, is the A
//   fragment of the next product) and K as the B operand, MN-major;
// - dk/dv: per q tile of each head of the group, S^T = K.Q^T and
//   dP^T = V.dO^T with the keys as M, p^T and ds^T in registers (lse and
//   delta, per q column, come through shared memory with the tile), then
//   dV += p^T.dO and dK += ds^T.Q with dO and Q as MN-major B operands; dk
//   and dv stay in registers across the whole group loop.
// Operands are staged as bf16 in the swizzled layout wgmma's descriptors
// read (hopper_wgmma.cuh: 128-byte swizzle for D = 64 and 128, 64-byte for
// 32) by cp.async with zero-fill past S, into a ring of two stages: the
// next kv tile (dq) or q/dO tile (dk/dv) loads while wgmma runs on this one.
// No scalar product touches bf16 data.
//
// Budget per warpgroup (ptxas -v for sm_90a, see `<lib>.log` beside the
// built library; bytes of dynamic shared memory from the code):
// - dq: Q and dO tiles plus two stages of K and V, 6 x 64 x D x 2 bytes
//   (+1 KB for alignment): 25, 49 and 97 KB for D = 32, 64, 128;
//   accumulators S and dP (32 + 32 f32) and dQ (D / 2) per thread;
// - dk/dv: K and V plus two stages of Q, dO, lse and delta,
//   (6 x 64 x D x 2 + 3 KB): 27, 51 and 99 KB; accumulators S^T, dP^T
//   (32 + 32) and dK, dV (D / 2 each) per thread, 192 f32 at D = 128.
// ptxas -v for sm_90a reports 145 / 128 / 166 registers per
// thread for dq and 162 / 168 / 252 for dk/dv at D = 32 / 64 / 128, and no
// spills: at D = 64, 4 dq or 3 dk/dv blocks fit on an SM. chip_smoke.py
// prints the report of every build.
//
// f32 inputs keep the scalar-FMA kernels (flash_dq_kernel,
// flash_dkv_kernel): 64 x 64 tiles staged as f32 in shared memory, each
// thread a 4 x 4 register tile of the score matrix. They serve f32 programs
// and the f32 gradient checks; the dispatch below is by dtype, and neither
// path stands in for the other.
//
// Work split: the TPU grids carry their accumulators across a sequential
// grid axis in VMEM. Here one block owns one output tile and loops:
// - dq:  one block per (batch*head, 64-row q tile), looping over the live
//        kv tiles (the TPU grid's nk axis);
// - dkv: one block per (batch*kv head, 64-key tile), looping over the G
//        query heads of the group and their live q tiles (the TPU grid's
//        nq*G axis).
// Tiles are 64 x 64 in both: at the main shape dq has B*H*S/64 = 2048
// blocks and dk/dv B*KV*S/64 = 512 over 132 SMs, several resident per SM
// (shared memory allows 4 of either at D = 64); larger key tiles would halve
// dk/dv's blocks to 256, fewer than two per SM, with the causal work spread
// 64:1 between the first and the last.
// No atomics: each output element is summed by one thread in a fixed
// order, so repeated runs give the same bits. Blocks with the most causal
// work are issued first (q tiles from the end, kv tiles from the start);
// causal tiles that are fully masked are skipped, and only the diagonal and
// ragged (past S) tiles pay for the mask.
// Layout: q/dO [B,S,H,D] and k/v [B,S,KV,D] are read by stride (last dim
// contiguous; the bf16 kernels need 16-byte aligned rows, which the wrapper
// checks); lse and delta are [B,H,S] f32 contiguous; dq [B,S,H,D] and dk/dv
// [B,S,KV,D] are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = 4;        // tile rows per thread (64 / 16)
constexpr int CPT = 4;        // tile columns per thread (64 / 16)
constexpr int PP = 65;        // padded row of the 64 x 64 P / dS tiles
constexpr float NEG_INF = -1e30f;  // the TPU kernels' causal mask value

// The scalar kernels are instantiated for float only (bf16 runs on the
// wgmma kernels); the conversions keep their dtype-generic form.
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// x.astype(T) then back to f32: the value a product in T's dtype sees
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// rows [r0, r0 + 64) of a [S, D] slice with row stride `ld` into a
// [64][D + 1] f32 tile; rows past S read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long ld, int r0, int S) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int s = r0 + r;
    dst[r * DP + c] = s < S ? to_f32<T>(src[s * ld + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V [64][D+1] and dS [BQ][BKV+1], all f32
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * PP);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO [64][D+1], P^T and dS^T [BKV][BQ+1], lse and delta [BQ]
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BKV * PP + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int S, int H, int group,
                long long sq_b, long long sq_s, long long sq_h,
                long long sk_b, long long sk_s, long long sk_h,
                long long sv_b, long long sv_s, long long sv_h,
                long long sd_b, long long sd_s, long long sd_h,
                float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;    // odd row stride: the 16 rows a half-warp
                               // reads sit on 16 distinct banks
  constexpr int DPT = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DP;
  float* Ks = dOs + BQ * DP;
  float* Vs = Ks + BKV * DP;
  float* dSs = Vs + BKV * DP;

  const int tx = threadIdx.x & 15;  // key / dq-column lane
  const int ty = threadIdx.x >> 4;  // row group: rows ty*RPT .. ty*RPT+RPT-1
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;

  load_tile<T, D>(Qs, q + b * sq_b + h * sq_h, sq_s, q0, S);
  load_tile<T, D>(dOs, dout + b * sd_b + h * sd_h, sd_s, q0, S);
  const T* kb = k + b * sk_b + kvh * sk_h;
  const T* vb = v + b * sv_b + kvh * sv_h;

  float lse_r[RPT], delta_r[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    lse_r[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(long long)bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // causal: kv tiles starting past the q tile's last row are fully masked
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // Q/dO written / previous tile's K and dS reads done
    load_tile<T, D>(Ks, kb, sk_s, k0, S);
    load_tile<T, D>(Vs, vb, sv_s, k0, S);
    __syncthreads();

    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(ty * RPT + i) * DP + d];
        ov[i] = dOs[(ty * RPT + i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (causal && col > row) x = NEG_INF;
        // keys past the sequence (S not a multiple of 64) carry no mass
        const float p = col < S ? expf(x - lse_r[i]) : 0.f;
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        // ds.astype(k.dtype) before ds.K, as _dq_kernel does
        dSs[(ty * RPT + i) * PP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BKV; ++kk) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(ty * RPT + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const float kx = Ks[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][c] = fmaf(dsv[i], kx, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row < S) {
      T* out = dq + (((long long)b * S + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv,
                 int S, int H, int KV, int group,
                 long long sq_b, long long sq_s, long long sq_h,
                 long long sk_b, long long sk_s, long long sk_h,
                 long long sv_b, long long sv_s, long long sv_h,
                 long long sd_b, long long sd_s, long long sd_h,
                 float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;
  constexpr int DPT = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BKV * DP;
  float* Qs = Vs + BKV * DP;
  float* dOs = Qs + BQ * DP;
  float* Pt = dOs + BQ * DP;      // p^T, rounded to dO's dtype
  float* dSt = Pt + BKV * PP;     // ds^T, rounded to q's dtype
  float* lse_s = dSt + BKV * PP;
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q-row / output-column lane
  const int ty = tid >> 4;  // key group: keys ty*RPT .. ty*RPT+RPT-1
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // early kv tiles (most causal work) first
  const int b = bkv / KV;
  const int kvh = bkv % KV;

  load_tile<T, D>(Ks, k + b * sk_b + kvh * sk_h, sk_s, k0, S);
  load_tile<T, D>(Vs, v + b * sv_b + kvh * sv_h, sv_s, k0, S);

  float dk_acc[RPT][DPT], dv_acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: q tiles ending before the kv tile's first key are fully masked
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;  // query heads h = kv * G + g share kv
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * sq_b + h * sq_h;
    const T* db = dout + b * sd_b + h * sd_h;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();  // previous tile's Q, dO, P^T and dS^T reads done
      load_tile<T, D>(Qs, qb, sq_s, q0, S);
      load_tile<T, D>(dOs, db, sd_s, q0, S);
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse[bh * S + row] : 0.f;
        delta_s[tid] = row < S ? delta[bh * S + row] : 0.f;
      }
      __syncthreads();

      float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kx[RPT], vx[RPT], qx[CPT], ox[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kx[i] = Ks[(ty * RPT + i) * DP + d];
          vx[i] = Vs[(ty * RPT + i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qx[j] = Qs[(tx + 16 * j) * DP + d];
          ox[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            sc[i][j] = fmaf(kx[i], qx[j], sc[i][j]);
            dp[i][j] = fmaf(vx[i], ox[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int key = k0 + ty * RPT + i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int r = tx + 16 * j;
          const int row = q0 + r;
          float x = sc[i][j] * scale;
          if (causal && key > row) x = NEG_INF;
          // query rows past the sequence carry no mass
          const float p = row < S ? expf(x - lse_s[r]) : 0.f;
          const float ds = p * (dp[i][j] - delta_s[r]) * scale;
          Pt[(ty * RPT + i) * PP + r] = round_to<T>(p);    // p.astype(do.dtype)
          dSt[(ty * RPT + i) * PP + r] = round_to<T>(ds);  // ds.astype(q.dtype)
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RPT], dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Pt[(ty * RPT + i) * PP + r];
          dsv[i] = dSt[(ty * RPT + i) * PP + r];
        }
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          const float ox = dOs[r * DP + tx + 16 * c];
          const float qx = Qs[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            dv_acc[i][c] = fmaf(pv[i], ox, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qx, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int key = k0 + ty * RPT + i;
    if (key < S) {
      const long long off = (((long long)b * S + key) * KV + kvh) * D;
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
        dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
      }
    }
  }
}

using hopper::LOG2E;
using hopper::WG;  // threads of the bf16 kernels: one warpgroup

template <int D>
constexpr size_t dq_wgmma_smem_bytes() {
  // Q, dO, then two stages of K and V, bf16 [64][D]; 1 KB to align
  return 6 * hopper::SwizzledTile<D>::BYTES + 1024;
}

template <int D>
constexpr size_t dkv_wgmma_smem_bytes() {
  // K, V, then two stages of (Q, dO, lse and delta in 1 KB); 1 KB to align
  return 2 * hopper::SwizzledTile<D>::BYTES + 2 * (2 * hopper::SwizzledTile<D>::BYTES + 1024) +
         1024;
}

// dq for bf16 on the tensor cores: one warpgroup per (b*h, 64-row q tile).
template <int D>
__global__ void __launch_bounds__(WG)
flash_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int S, int H, int group,
                      long long sq_b, long long sq_s, long long sq_h,
                      long long sk_b, long long sk_s, long long sk_h,
                      long long sv_b, long long sv_s, long long sv_h,
                      long long sd_b, long long sd_s, long long sd_h,
                      float scale, int causal) {
  using Tile = hopper::SwizzledTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + Tile::BYTES;
  // stage s: K at base + (2 + 2s) * BYTES, V right after it

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const __nv_bfloat16* kb = k + b * sk_b + kvh * sk_h;
  const __nv_bfloat16* vb = v + b * sv_b + kvh * sv_h;

  // causal: kv tiles starting past the q tile's last row are fully masked
  const int n_kv = ((causal ? min(S, q0 + BQ) : S) + BKV - 1) / BKV;
  Tile::load(sQ, q + b * sq_b + h * sq_h, sq_s, q0, S, tid, WG);
  Tile::load(sdO, dout + b * sd_b + h * sd_h, sd_s, q0, S, tid, WG);
  for (int it = 0; it < 2; ++it) {  // the ring's first two kv tiles
    if (it < n_kv) {
      const uint32_t sK = base + (2 + 2 * it) * Tile::BYTES;
      Tile::load(sK, kb, sk_s, it * BKV, S, tid, WG);
      Tile::load(sK + Tile::BYTES, vb, sv_s, it * BKV, S, tid, WG);
    }
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows: 16 * warp + g and 8 below it
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  float lse2[2], dlt[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int row = x ? row_b : row_a;
    lse2[x] = row < S ? lse[(long long)bh * S + row] * LOG2E : 0.f;
    dlt[x] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * BKV;
    const uint32_t sK = base + (2 + 2 * (it & 1)) * Tile::BYTES, sV = sK + Tile::BYTES;
    hopper::cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    hopper::fence_regs(s);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(s, Tile::k_major(sQ, kk), Tile::k_major(sK, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(dp, Tile::k_major(sdO, kk), Tile::k_major(sV, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // ds = p * (dp - delta) * scale, rounded to bf16 (k's dtype) in the A
    // fragment layout: register i/2 packs accumulator elements i and i+1
    const bool edge = (causal && k0 + BKV - 1 > q0) || k0 + BKV > S;
    uint32_t a[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int x = (i & 2) ? 1 : 0;  // row_a or row_b
      const int row = x ? row_b : row_a;
      const int col = k0 + 8 * (i >> 2) + 2 * t;
      float ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float p = exp2f(s[i + u] * scale_log2 - lse2[x]);
        // masked: the causal future (-1e30 in the reference, exp → 0) and
        // keys past the sequence, which carry no mass
        if (edge && ((causal && col + u > row) || col + u >= S)) p = 0.f;
        ds[u] = p * (dp[i + u] - dlt[x]) * scale;
      }
      a[i / 2] = hopper::pack_bf16(ds[0], ds[1]);
    }

    hopper::fence_regs(a);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hopper::WgmmaRsTransB<D>::run(acc, a + 4 * kk, Tile::mn_major(sK, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(a);

    __syncthreads();  // every warp is done with this stage: refill it
    if (it + 2 < n_kv) {
      Tile::load(sK, kb, sk_s, k0 + 2 * BKV, S, tid, WG);
      Tile::load(sV, vb, sv_s, k0 + 2 * BKV, S, tid, WG);
    }
    hopper::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int row = (i & 2) ? row_b : row_a;
    if (row < S) {
      __nv_bfloat16* out = dq + (((long long)b * S + row) * H + h) * D + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// dk/dv for bf16 on the tensor cores: one warpgroup per (b*kv head, 64-key
// tile), looping over the G query heads of the group and their q tiles.
template <int D>
__global__ void __launch_bounds__(WG)
flash_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                       int S, int H, int KV, int group,
                       long long sq_b, long long sq_s, long long sq_h,
                       long long sk_b, long long sk_s, long long sk_h,
                       long long sv_b, long long sv_s, long long sv_h,
                       long long sd_b, long long sd_s, long long sd_h,
                       float scale, int causal) {
  using Tile = hopper::SwizzledTile<D>;
  constexpr uint32_t STAGE = 2 * Tile::BYTES + 1024;  // Q, dO, lse[64], delta[64]
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + Tile::BYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // early kv tiles (most causal work) first
  const int b = bkv / KV;
  const int kvh = bkv % KV;

  // causal: q tiles ending before the kv tile's first key are fully masked
  const int first = causal ? k0 / BQ : 0;
  const int per_head = (S + BQ - 1) / BQ - first;
  const int jobs = group * per_head;  // (head of the group, q tile) pairs

  auto load_job = [&](int job) {
    const int h = kvh * group + job / per_head;  // query heads h = kv * G + g
    const int q0 = (first + job % per_head) * BQ;
    const uint32_t sQ = base + 2 * Tile::BYTES + (job & 1) * STAGE;
    Tile::load(sQ, q + b * sq_b + h * sq_h, sq_s, q0, S, tid, WG);
    Tile::load(sQ + Tile::BYTES, dout + b * sd_b + h * sd_h, sd_s, q0, S, tid, WG);
    if (tid < BQ) {
      const uint32_t stats = sQ + 2 * Tile::BYTES;
      const bool live = q0 + tid < S;
      const long long at = ((long long)b * H + h) * S + (live ? q0 + tid : 0);
      hopper::cp_async4(stats + 4 * tid, lse + at, live ? 4 : 0);
      hopper::cp_async4(stats + 4 * (BQ + tid), delta + at, live ? 4 : 0);
    }
  };

  Tile::load(sK, k + b * sk_b + kvh * sk_h, sk_s, k0, S, tid, WG);
  Tile::load(sV, v + b * sv_b + kvh * sv_h, sv_s, k0, S, tid, WG);
  for (int job = 0; job < 2; ++job) {  // the ring's first two q tiles
    if (job < jobs) load_job(job);
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows (keys): 16 * warp + g and 8 below it
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  const float scale_log2 = scale * LOG2E;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int job = 0; job < jobs; ++job) {
    const int q0 = (first + job % per_head) * BQ;
    const uint32_t sQ = base + 2 * Tile::BYTES + (job & 1) * STAGE, sdO = sQ + Tile::BYTES;
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (sdO + Tile::BYTES - raw));
    const float* delta_s = lse_s + BQ;
    hopper::cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncthreads();

    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns q rows
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(st, Tile::k_major(sK, kk), Tile::k_major(sQ, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_m64n64k16_ss(dpt, Tile::k_major(sV, kk), Tile::k_major(sdO, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // p^T rounded to dO's dtype and ds^T to q's, in the A fragment layout
    const bool edge = (causal && q0 < k0 + BKV - 1) || q0 + BQ > S;
    uint32_t ap[16], ads[16];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int key = (i & 2) ? key_b : key_a;
      const int c = 8 * (i >> 2) + 2 * t;  // q column within the tile
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + c);
      float p[2], ds[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = q0 + c + u;
        p[u] = exp2f(st[i + u] * scale_log2 - (u ? l2.y : l2.x) * LOG2E);
        // masked: the causal future and query rows past the sequence
        if (edge && ((causal && key > row) || row >= S)) p[u] = 0.f;
        ds[u] = p[u] * (dpt[i + u] - (u ? dl.y : dl.x)) * scale;
      }
      ap[i / 2] = hopper::pack_bf16(p[0], p[1]);
      ads[i / 2] = hopper::pack_bf16(ds[0], ds[1]);
    }

    hopper::fence_regs(ap);
    hopper::fence_regs(ads);
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::WgmmaRsTransB<D>::run(dv_acc, ap + 4 * kk, Tile::mn_major(sdO, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::WgmmaRsTransB<D>::run(dk_acc, ads + 4 * kk, Tile::mn_major(sQ, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(ap);
    hopper::fence_regs(ads);

    __syncthreads();  // every warp is done with this stage: refill it
    if (job + 2 < jobs) load_job(job + 2);
    hopper::cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int key = (i & 2) ? key_b : key_a;
    if (key < S) {
      const long long off = (((long long)b * S + key) * KV + kvh) * D + 8 * (i >> 2) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) = __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) = __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

using hopper::opt_in_smem;

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq, or dk and dv
  int B, S, H, KV;
  long long sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h, sd_b, sd_s, sd_h;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_dq_kernel<T, D>;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.S, a.H, a.H / a.KV, a.sq_b, a.sq_s, a.sq_h,
      a.sk_b, a.sk_s, a.sk_h, a.sv_b, a.sv_s, a.sv_h, a.sd_b, a.sd_s, a.sd_h,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_dkv_kernel<T, D>;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.KV, (a.S + BKV - 1) / BKV);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.H, a.KV,
      a.H / a.KV, a.sq_b, a.sq_s, a.sq_h, a.sk_b, a.sk_s, a.sk_h, a.sv_b,
      a.sv_s, a.sv_h, a.sd_b, a.sd_s, a.sd_h, a.scale, a.causal);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int D>
cudaError_t launch_dq_wgmma(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_dq_wgmma_kernel<D>;
  const size_t smem = dq_wgmma_smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.S, a.H, a.H / a.KV, a.sq_b, a.sq_s, a.sq_h,
      a.sk_b, a.sk_s, a.sk_h, a.sv_b, a.sv_s, a.sv_h, a.sd_b, a.sd_s, a.sd_h,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Args& a) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kernel = flash_dkv_wgmma_kernel<D>;
  const size_t smem = dkv_wgmma_smem_bytes<D>();
  cudaError_t err = opt_in_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.KV, (a.S + BKV - 1) / BKV);
  kernel<<<grid, WG, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.S, a.H, a.KV,
      a.H / a.KV, a.sq_b, a.sq_s, a.sq_h, a.sk_b, a.sk_s, a.sk_h, a.sv_b,
      a.sv_s, a.sv_h, a.sd_b, a.sd_s, a.sd_h, a.scale, a.causal);
  return cudaGetLastError();
}

// the scalar-FMA instances for float32, the wgmma instances for bfloat16
template <typename T, int D> struct DqLaunch;
template <int D> struct DqLaunch<float, D> {
  static cudaError_t run(const Args& a) { return launch_dq<float, D>(a); }
};
template <int D> struct DqLaunch<bf16, D> {
  static cudaError_t run(const Args& a) { return launch_dq_wgmma<D>(a); }
};
template <typename T, int D> struct DkvLaunch;
template <int D> struct DkvLaunch<float, D> {
  static cudaError_t run(const Args& a) { return launch_dkv<float, D>(a); }
};
template <int D> struct DkvLaunch<bf16, D> {
  static cudaError_t run(const Args& a) { return launch_dkv_wgmma<D>(a); }
};

// dtype (0 = float32, 1 = bfloat16) x head dim → the kernel instance
template <template <typename, int> class Launch>
int dispatch(int dtype, int D, const Args& a) {
  if (a.KV <= 0 || a.H % a.KV != 0) return (int)cudaErrorInvalidValue;
#define POLYAXON_FLASH_BWD_CASE(TYPE, DIM) \
  if (D == DIM) return (int)Launch<TYPE, DIM>::run(a);
  if (dtype == 0) {
    POLYAXON_FLASH_BWD_CASE(float, 32)
    POLYAXON_FLASH_BWD_CASE(float, 64)
    POLYAXON_FLASH_BWD_CASE(float, 128)
  } else if (dtype == 1) {
    POLYAXON_FLASH_BWD_CASE(bf16, 32)
    POLYAXON_FLASH_BWD_CASE(bf16, 64)
    POLYAXON_FLASH_BWD_CASE(bf16, 128)
  }
#undef POLYAXON_FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Strides are in elements, for q, k, v and dO in that order; the last dim of
// each must be contiguous. lse and delta are [B,H,S] float32 contiguous.
// Each returns cudaGetLastError() after its launch (0 on success).
extern "C" int polyaxon_flash_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    int dtype, int B, int S, int H, int KV, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long sv_b, long long sv_s, long long sv_h,
    long long sd_b, long long sd_s, long long sd_h,
    float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, KV,
               sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
               sd_b, sd_s, sd_h, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DqLaunch>(dtype, D, a);
}

extern "C" int polyaxon_flash_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    int dtype, int B, int S, int H, int KV, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long sv_b, long long sv_s, long long sv_h,
    long long sd_b, long long sd_s, long long sd_h,
    float scale, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, KV,
               sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
               sd_b, sd_s, sd_h, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<DkvLaunch>(dtype, D, a);
}
