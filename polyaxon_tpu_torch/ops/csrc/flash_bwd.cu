// Flash-attention backward for Hopper (sm_90a), scalar-FMA first version.
//
// Replaces: polyaxon_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (both launched by _bwd_impl through pl.pallas_call). Same function, the
// FlashAttention-2 recipe: p = exp(s - lse) is recomputed from the forward's
// logsumexp, ds = p * (dO.V^T - delta) * scale, then
//   dq  = ds . K                     (flash_dq_kernel)
//   dv  = p^T . dO,  dk = ds^T . Q   (flash_dkv_kernel, summed over the
//                                     query heads of each GQA group)
// with f32 scores and accumulators and the TPU kernels' rounding points:
// ds is rounded to k's dtype before ds.K, p to dO's dtype before p^T.dO and
// ds to q's dtype before ds^T.Q; outputs are written in the input dtype.
// `delta` (rowsum(dO * o), minus the lse cotangent where there is one) is
// computed outside, as the reference computes it outside its kernels.
//
// What bounds it: at the main-path shape (B=1, S=4096, H=32, KV=8, D=64,
// bf16, causal) dq does 3 products (6*B*H*pairs*D = 103 GFLOP) and dk/dv 4
// (138 GFLOP) against ~42 MB of inputs and outputs each: compute-bound, far
// above the card's ~295 bf16 operations per byte.
//
// What the design does about it: nothing of the S x S matrices leaves the
// SM. Both kernels recompute their score tile in registers (each thread owns
// a 4x4 tile of it, so every shared-memory word read feeds 4 FMAs) and skip
// causal tiles that are fully masked. It still runs on the CUDA cores in
// f32, not on the tensor cores; mma/wgmma is the next step for speed.
//
// Work split: the TPU grids carry their accumulators across a sequential
// grid axis in VMEM. Here one block owns one output tile and loops:
// - dq:  one block per (batch*head, 64-row q tile), looping over the live
//        kv tiles (the TPU grid's nk axis); dq stays in f32 registers;
// - dkv: one block per (batch*kv head, 64-key tile), looping over the G
//        query heads of the group and their live q tiles (the TPU grid's
//        nq*G axis); dk and dv stay in f32 registers.
// No atomics: each output element is summed by one thread in a fixed
// order, so repeated runs give the same bits. Blocks with the most causal
// work are issued first (q tiles from the end, kv tiles from the start).
// Layout: q/dO [B,S,H,D] and k/v [B,S,KV,D] are read by stride (last dim
// contiguous); lse and delta are [B,H,S] f32 contiguous; dq [B,S,H,D] and
// dk/dv [B,S,KV,D] are written contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = 4;        // tile rows per thread (64 / 16)
constexpr int CPT = 4;        // tile columns per thread (64 / 16)
constexpr int PP = 65;        // padded row of the 64 x 64 P / dS tiles
constexpr float NEG_INF = -1e30f;  // the TPU kernels' causal mask value

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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

// The shared-memory opt-in above 48 KB, set once per device for each kernel
// instance (one bit per device ordinal), not on every launch.
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t bytes,
                        std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

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
    POLYAXON_FLASH_BWD_CASE(__nv_bfloat16, 32)
    POLYAXON_FLASH_BWD_CASE(__nv_bfloat16, 64)
    POLYAXON_FLASH_BWD_CASE(__nv_bfloat16, 128)
  }
#undef POLYAXON_FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int D> struct DqLaunch {
  static cudaError_t run(const Args& a) { return launch_dq<T, D>(a); }
};
template <typename T, int D> struct DkvLaunch {
  static cudaError_t run(const Args& a) { return launch_dkv<T, D>(a); }
};

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
