// Weight-only int8 projection for Hopper (sm_90a):
//   y[m, n] = (sum_k x[m, k] * Wq[n, k] in f32) * scale[n], cast to x's type.
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
// Layouts: x [M, K] row-major (row stride ldx, elements), Wq [N, K] int8
// row-major (nn.Linear's [out, in]), scale [N] f32, y [M, N] row-major (row
// stride ldy). K must be a multiple of 16 and the rows of x and Wq must
// start on 16-byte boundaries (the wrapper checks both).
//
// What bounds it. Decode (M <= 8 rows) reads N*K weight bytes for 2*M*N*K
// operations: at M = 8 that is 16 operations per byte, far below the
// card's ~295 bf16 operations per byte, so the weight stream bounds it:
// one llama3-1b decode step reads 0.97 GB of int8 projections, ~0.29 ms at
// 3.35 TB/s. Prefill (M in the thousands) is the other side of the line:
// 2*M*N*K operations on the tensor cores.
//
// The design does about that:
// - int8_gemv_mma_kernel (M <= 8, bf16): the weight rows are the tensor
//   cores' A operand and x's rows their n = 8 B operand (y^T = Wq . x^T),
//   loaded straight into mma.sync fragments with 16-byte loads, four
//   64-wide K chunks in flight a warp and 8 warps splitting K; int8 widens
//   to bf16 by byte permutes and one FADD (no I2F, whose quarter rate made
//   an earlier scalar version of this path compute-bound at M = 8). No tile of M-sized
//   rows is staged, so no shared memory sits mostly empty.
// - int8_mma_kernel (M > 8, bf16): 64 x 64 output tiles, 4 warps each
//   computing 32 x 32 with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   Each 64 x 32 slab of x is copied to shared memory as bf16; each 64 x 32
//   slab of Wq is loaded as int8 (16 bytes a thread) and widened to bf16 on
//   its way into shared memory (bf16 holds every integer in [-127, 127]
//   exactly, so the products are the exact int8 x bf16 products). The next
//   slab is fetched into registers while the tensor cores work on this one.
// - int8_fma_kernel (f32, any M): the same tiling on the CUDA cores, each
//   thread a 4 x 4 register tile, x and the widened weights as f32 in
//   shared memory; it serves the f32 parity configurations, which no
//   serving path runs, so it has no small-M kernel of its own.
// Not done yet (a later PR): TMA, wgmma, and splitting K across blocks for
// the small-N decode shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// 16 int8 (one int4) → 16 f32
__device__ __forceinline__ void widen16(const int4& v, float* out) {
  const int words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[i * 4 + j] = static_cast<float>(static_cast<int8_t>((words[i] >> (8 * j)) & 0xff));
    }
  }
}

// ----------------------------------------------------- large M, bf16 mma
constexpr int BM = 64, BN = 64, BK = 32, SPAD = 8;  // pad: conflict-free fragment reads
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 int8 → 16 bf16 packed in two int4
__device__ __forceinline__ void widen16_bf16(const int4& v, int4* out) {
  float f[16];
  widen16(v, f);
  __nv_bfloat162 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  out[0] = *reinterpret_cast<const int4*>(&h[0]);
  out[1] = *reinterpret_cast<const int4*>(&h[4]);
}

__global__ void __launch_bounds__(MMA_THREADS)
int8_mma_kernel(const bf16* __restrict__ x, long long ldx,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                bf16* __restrict__ y, long long ldy, int M, int N, int K) {
  __shared__ __align__(16) bf16 As[BM][BK + SPAD];
  __shared__ __align__(16) bf16 Bs[BN][BK + SPAD];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // what each thread copies: two 8-element chunks of the x slab, one
  // 16-weight chunk of the Wq slab
  int a_row[2], a_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * MMA_THREADS;
    a_row[i] = c >> 2;
    a_col[i] = (c & 3) * 8;
  }
  const int b_row = tid >> 1, b_col = (tid & 1) * 16;

  int4 a_reg[2], b_reg;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gm = m0 + a_row[i], gk = k0 + a_col[i];
      a_reg[i] = make_int4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        a_reg[i] = *reinterpret_cast<const int4*>(x + (long long)gm * ldx + gk);
      }
    }
    const int gn = n0 + b_row, gk = k0 + b_col;
    b_reg = make_int4(0, 0, 0, 0);
    if (gn < N && gk < K) {
      b_reg = __ldg(reinterpret_cast<const int4*>(w + (long long)gn * K + gk));
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<int4*>(&As[a_row[i]][a_col[i]]) = a_reg[i];
    }
    int4 h[2];
    widen16_bf16(b_reg, h);
    *reinterpret_cast<int4*>(&Bs[b_row][b_col]) = h[0];
    *reinterpret_cast<int4*>(&Bs[b_row][b_col + 8]) = h[1];
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[4][2];
      const int c = kk + tig * 2;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16 + group;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][c]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][c + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn + ni * 8 + group;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][c]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][c + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
  // accumulator fragment: c0, c1 at (group, 2 tig + {0, 1}); c2, c3 eight rows down
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + group + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j < N) {
            y[(long long)row * ldy + col + j] =
                __float2bfloat16(acc[mi][ni][2 * h + j] * scale[col + j]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------ small M, bf16 mma
// y^T = Wq . x^T on the tensor cores: the int8 rows are mma's A operand (16
// output columns a tile, "row"), the <= 8 rows of x its B operand (n = 8),
// so no M-sized tile is padded to 16 rows of x. A lane loads 16 int8 of two
// weight rows and 16 bf16 of one x row with 16-byte loads and feeds them to
// four m16n8k16 steps: the dot product is over K, so each 64-wide chunk of
// K is permuted alike on both sides (step s, fragment column 2t + j of the
// lane quad t takes K offset 16 t + 4 s + j, and 2t + 8 + j takes 16 t + 4 s
// + 2 + j), which puts a lane's own 16 contiguous bytes in its fragments.
// int8 widens to bf16 exactly without I2F: a byte b + 128 sits in the
// mantissa of 2^23 (one byte_perm), one FADD removes 2^23 + 128, and the
// integer's bf16 is the f32's upper half (exact for |b| <= 128). The
// WARPS warps of a block (8, or 16 for K past 2048, so that the down
// projection's 128 blocks keep as many loads in flight as the others) split
// K and add their partial tiles through shared memory in a fixed order.
constexpr int SG_MMAX = 8;    // rows of x it takes (mma's n = 8)
constexpr int SG_COLS = 16;   // output columns of a block (mma's 16 rows)
constexpr int SG_UNROLL = 4;  // 64-wide K chunks a warp keeps in flight

// four int8 (one word) → two bf16x2 words: bytes 0,1 and bytes 2,3
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

template <int SG_WARPS>
__global__ void __launch_bounds__(SG_WARPS * 32)
int8_gemv_mma_kernel(const bf16* __restrict__ x, long long ldx,
                     const int8_t* __restrict__ w, const float* __restrict__ scale,
                     bf16* __restrict__ y, long long ldy, int M, int N, int K) {
  __shared__ float part[SG_WARPS][32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SG_COLS;
  const int rows[2] = {n0 + g, n0 + g + 8};
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int chunks = (K + 63) / 64;
  for (int c0 = warp; c0 < chunks; c0 += SG_WARPS * SG_UNROLL) {
    int4 wv[SG_UNROLL][2], xv[SG_UNROLL][2];
#pragma unroll
    for (int u = 0; u < SG_UNROLL; ++u) {
      const int k = (c0 + u * SG_WARPS) * 64 + 16 * t;
      const bool live = c0 + u * SG_WARPS < chunks && k < K;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wv[u][r] = make_int4(0, 0, 0, 0);
        if (live && rows[r] < N) {
          wv[u][r] = __ldg(reinterpret_cast<const int4*>(w + (long long)rows[r] * K + k));
        }
        xv[u][r] = make_int4(0, 0, 0, 0);
        if (live && g < M) {
          xv[u][r] = *reinterpret_cast<const int4*>(x + (long long)g * ldx + k + 8 * r);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SG_UNROLL; ++u) {
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&wv[u][0]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&wv[u][1]);
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv[u][0]);  // 8 words
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[4], b[2];
        widen4_bf16(w0[s], a[0], a[2]);
        widen4_bf16(w1[s], a[1], a[3]);
        b[0] = xw[2 * s];
        b[1] = xw[2 * s + 1];
        mma_bf16_16816(acc, a, b);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) part[warp][lane][r] = acc[r];
  __syncthreads();
  const int i = threadIdx.x;
  if (i < 128) {
    const int l = i >> 2, r = i & 3;
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < SG_WARPS; ++v) sum += part[v][l][r];
    // accumulator fragment: c0, c1 at (row g, col 2t + {0, 1}), c2, c3 at row g + 8
    const int n = n0 + (l >> 2) + (r >> 1) * 8;
    const int m = 2 * (l & 3) + (r & 1);
    if (m < M && n < N) y[(long long)m * ldy + n] = __float2bfloat16(sum * scale[n]);
  }
}

// ------------------------------------------------------ large M, f32 FMA
constexpr int FBK = 16, FPAD = 4, FMA_THREADS = 256;

__global__ void __launch_bounds__(FMA_THREADS)
int8_fma_kernel(const float* __restrict__ x, long long ldx,
                const int8_t* __restrict__ w, const float* __restrict__ scale,
                float* __restrict__ y, long long ldy, int M, int N, int K) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). bf16 takes the
// weight-streaming kernel for M <= 8 and the tiled tensor-core kernel for
// larger M; f32 takes the tiled CUDA-core kernel for every M. Returns
// cudaGetLastError() after the launch (0 on success); invalid shapes
// return cudaErrorInvalidValue unlaunched.
extern "C" int polyaxon_int8_matmul(
    const void* x, const void* w, const void* scale, void* y,
    int dtype, int M, int N, int K, long long ldx, long long ldy, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && M <= SG_MMAX) {
    const int blocks = (N + SG_COLS - 1) / SG_COLS;
    const bf16* xb = static_cast<const bf16*>(x);
    const int8_t* wb = static_cast<const int8_t*>(w);
    const float* sb = static_cast<const float*>(scale);
    bf16* yb = static_cast<bf16*>(y);
    if (K > 2048) {
      int8_gemv_mma_kernel<16><<<blocks, 16 * 32, 0, s>>>(xb, ldx, wb, sb, yb, ldy, M, N, K);
    } else {
      int8_gemv_mma_kernel<8><<<blocks, 8 * 32, 0, s>>>(xb, ldx, wb, sb, yb, ldy, M, N, K);
    }
    return (int)cudaGetLastError();
  }
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 1) {
    int8_mma_kernel<<<grid, MMA_THREADS, 0, s>>>(
        static_cast<const bf16*>(x), ldx, static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<bf16*>(y), ldy, M, N, K);
  } else {
    int8_fma_kernel<<<grid, FMA_THREADS, 0, s>>>(
        static_cast<const float*>(x), ldx, static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(y), ldy, M, N, K);
  }
  return (int)cudaGetLastError();
}
