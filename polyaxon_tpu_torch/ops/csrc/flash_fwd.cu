// Flash-attention forward for Hopper (sm_90a), scalar-FMA first version.
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
// bf16, causal) the work is 4*B*H*S^2*D/2 = 68.7 GFLOP against 42 MB of
// inputs and outputs, about 1600 operations per byte, far above the
// card's ~295 bf16 operations per byte: the kernel is compute-bound.
//
// What the design does about it: the O(S^2) score matrix never leaves the
// SM, so device memory is touched once per q tile for Q/O and once per
// (q tile, kv tile) for K/V (served mostly from L2 since the 4 heads of a
// GQA group and all q tiles of a head read the same K/V). Fully masked kv
// tiles are never loaded. Inside the block the two products are register
// tiled (each thread owns a 4x4 score tile and a 4x(D/16) output tile),
// so every shared-memory word read feeds 4 FMAs. It still runs on the
// CUDA cores in f32, not on the tensor cores; moving both products onto
// mma/wgmma is the next step for speed.
//
// Work split: one thread block owns one (batch*head, 64-row q tile); the
// TPU grid's sequential kv dimension is the loop inside the block.
// Layout: q [B,S,H,D] and k/v [B,S,KV,D] are read by stride (last dim
// contiguous), so no transposed copy is made; o is written [B,S,H,D]
// contiguous and lse [B,H,S] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int RPT = BQ / 16;  // query rows per thread
constexpr int CPT = BKV / 16; // keys per thread
constexpr int PP = BKV + 1;   // padded row of the P tile
constexpr float NEG_INF = -1e30f;  // the TPU kernel's causal mask value

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int KV,
                   long long sq_b, long long sq_s, long long sq_h,
                   long long sk_b, long long sk_s, long long sk_h,
                   long long sv_b, long long sv_s, long long sv_h,
                   float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  // the shared-memory opt-in is set once per device for each instance, not
  // on every launch (one bit per device ordinal)
  static std::atomic<unsigned long long> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, H, H / KV, sq_b, sq_s, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, void* lse, int B, int S, int H, int KV,
                       long long sq_b, long long sq_s, long long sq_h,
                       long long sk_b, long long sk_s, long long sk_h,
                       long long sv_b, long long sv_s, long long sv_h,
                       float scale, int causal, cudaStream_t stream) {
#define POLYAXON_FLASH_CASE(DIM)                                              \
  case DIM:                                                                  \
    return launch<T, DIM>(q, k, v, o, lse, B, S, H, KV, sq_b, sq_s, sq_h,    \
                          sk_b, sk_s, sk_h, sv_b, sv_s, sv_h, scale, causal, \
                          stream);
  switch (D) {
    POLYAXON_FLASH_CASE(32)
    POLYAXON_FLASH_CASE(64)
    POLYAXON_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef POLYAXON_FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim
// of q, k and v must be contiguous. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int polyaxon_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int dtype, int B, int S, int H, int KV, int D,
    long long sq_b, long long sq_s, long long sq_h,
    long long sk_b, long long sk_s, long long sk_h,
    long long sv_b, long long sv_s, long long sv_h,
    float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, o, lse, B, S, H, KV, sq_b, sq_s,
                                  sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
                                  scale, causal, st);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, S, H, KV,
                                          sq_b, sq_s, sq_h, sk_b, sk_s, sk_h,
                                          sv_b, sv_s, sv_h, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
