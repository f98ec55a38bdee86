// Forward flash attention for Hopper (sm_90a): online softmax over key blocks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (and its GQA wrapper repro/kernels/ops.py:gqa_flash_attention).  Layouts are
// the wrapper's: q [B, Sq, H, hd], k [B, Skv, Hkv, hd], v [B, Skv, Hkv, hd_v],
// out [B, Sq, H, hd_v], all contiguous, in f32, bf16 or f16; every product and
// sum is taken in f32 and the output is rounded once to q's type.  Query head
// h reads kv head h / (H / Hkv): no repeated kv is made.
//
// What it computes (as the Pallas kernel): scores q.k / sqrt(hd); a key is
// seen iff k_pos < seq_kv, and, when causal, k_pos <= q_pos and (with a
// window) q_pos - k_pos < window.  A masked score is -1e30, not -inf, so a
// row with no key seen yet never turns into NaN; running max m, sum l and
// accumulator acc are rescaled by exp(m_old - m_new) per key block; the
// output is acc / max(l, 1e-30).  Key blocks wholly above the diagonal are
// skipped, and so are blocks wholly outside a causal window (their
// contributions would be scaled by exp(-1e30 - m) = 0 exactly).
//
// Grid: blockIdx.x a block of 64 query rows, .y the query head, .z the batch
// row.  On the TPU the key blocks were the sequential last grid axis with
// m, l, acc in VMEM scratch; here Hopper's blocks run in no order, so one
// thread block owns its query block and walks the key blocks in a loop, with
// m, l and acc in registers.  256 threads as a 16 x 16 grid: thread (ty, tx)
// owns query rows ty + 16r (r < 4), the score columns tx + 16c (c < 4) of each
// 64-key block, and the output columns tx + 16c (c < 8, so hd_v <= 128).  A
// row's 16 owners sit in one half-warp and reduce its max and sum with
// __shfl_xor_sync.  Q, K and V tiles are staged as f32 in dynamic shared
// memory (rows of Q and K padded to an odd stride, so the 16 rows a warp
// reads at one depth fall in 16 banks), and so is the 64 x 64 probability
// tile for the P.V product.  The head width is a runtime size (zamba2 and
// h2o-danube use 80, not a multiple of 64), and the ragged sequence edge is a
// mask, not a pad.
//
// What bounds it on an H100: operations.  Causal attention at zamba2's
// prefill (B 2, S 4096, 32 heads of 80) is 172 GFLOP against 84 MB of q, k,
// v and out: 0.17 ms at the 989 TFLOP/s of bf16 tensor cores, 0.03 ms of
// memory.  This first version does its products in f32 on the CUDA cores
// (67 TFLOP/s at most), from shared memory, so it runs far from that bound;
// wgmma on bf16 tiles fed by TMA is later work.
//
// C interface (bound with ctypes): the entry point makes the given device
// current, launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 = success), or the error of a refused
// cudaFuncSetAttribute (too much shared memory).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                   // query rows per thread block
constexpr int kBK = 64;                   // keys per block of the loop
constexpr int kThreads = 256;
constexpr int kMaxCols = 8;               // output columns a thread: hd_v <= 128
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "load_tile stages 64-row tiles of q, k and v");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

struct Dims {
  int64_t Sq, Skv, H, Hkv, hd, hd_v, seq_kv, window;  // window <= 0: none
  int causal;
  float scale;
};

__host__ __device__ __forceinline__ int64_t odd_stride(int64_t n) { return n | 1; }

size_t smem_bytes(int64_t hd, int64_t hd_v) {
  return sizeof(float) * ((kBQ + kBK) * odd_stride(hd) + kBK * hd_v + kBQ * (kBK + 1));
}

// Stage rows [row0, row0 + 64) of head `head` of a [batch, seq, heads, width]
// tensor as f32 into dst[r * ld + c]; rows at or past `seq` read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int64_t ld, const T* src,
                                          int64_t b, int64_t row0, int64_t seq,
                                          int64_t heads, int64_t head,
                                          int64_t width) {
  const int w = (int)width;
  for (int i = threadIdx.x; i < kBK * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    const int64_t t = row0 + r;
    dst[r * ld + c] = t < seq ? to_f32(src[((b * seq + t) * heads + head) * width + c])
                              : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const int64_t ldq = odd_stride(d.hd), ldp = kBK + 1;
  float* sQ = smem;                       // [kBQ][ldq]
  float* sK = sQ + kBQ * ldq;             // [kBK][ldq]
  float* sV = sK + kBK * ldq;             // [kBK][hd_v]
  float* sP = sV + kBK * d.hd_v;          // [kBQ][ldp]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kvh = h / (d.H / d.Hkv);

  load_tile(sQ, ldq, q, b, q0, d.Sq, d.H, h, d.hd);

  float m[4], l[4], acc[4][kMaxCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  // The key blocks this query block visits (repro/models/attention.py
  // _chunk_bounds, with the query block's padded last row).
  const int64_t n_kv = (d.Skv + kBK - 1) / kBK;
  int64_t lo = 0, hi = n_kv;
  if (d.causal) {
    hi = (q0 + kBQ - 1) / kBK + 1;
    if (hi > n_kv) hi = n_kv;
    if (d.window > 0) {
      const int64_t first = q0 - d.window + 1;
      lo = first > 0 ? first / kBK : 0;
    }
  }
  if (hi < lo + 1) hi = lo + 1;

  for (int64_t kb = lo; kb < hi; ++kb) {
    const int64_t k0 = kb * kBK;
    __syncthreads();                      // the last block is done with sK, sV, sP
    load_tile(sK, ldq, k, b, k0, d.Skv, d.Hkv, kvh, d.hd);
    load_tile(sV, d.hd_v, v, b, k0, d.Skv, d.Hkv, kvh, d.hd_v);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int64_t e = 0; e < d.hd; ++e) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * ldq + e];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * ldq + e];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t qpos = q0 + ty + 16 * r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t kpos = k0 + tx + 16 * c;
        bool seen = kpos < d.seq_kv;
        if (d.causal) {
          seen = seen && kpos <= qpos;
          if (d.window > 0) seen = seen && qpos - kpos < d.window;
        }
        s[r][c] = seen ? s[r][c] * d.scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        sP[(ty + 16 * r) * ldp + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();                      // sP complete

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * ldp + j];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int64_t col = tx + 16 * c;
        if (col < d.hd_v) {
          const float vv = sV[j * d.hd_v + col];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pv[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t qpos = q0 + ty + 16 * r;
    if (qpos >= d.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = out + ((b * d.Sq + qpos) * d.H + h) * d.hd_v;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int64_t col = tx + 16 * c;
      if (col < d.hd_v) dst[col] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int64_t B,
           const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d.hd, d.hd_v);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((d.Sq + kBQ - 1) / kBQ), (unsigned)d.H, (unsigned)B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16, 2 = f16.  window <= 0 means no window (a
// window applies only with causal, as in the reference).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int64_t B, int64_t Sq, int64_t Skv,
                           int64_t H, int64_t Hkv, int64_t hd, int64_t hd_v,
                           int64_t seq_kv, int causal, int64_t window,
                           int dtype, int device, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || H < 1 || Hkv < 1 || H % Hkv || hd < 1 ||
      hd_v < 1 || hd_v > 16 * kMaxCols || B > 65535 || H > 65535 ||
      (Sq + kBQ - 1) / kBQ > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims d{Sq, Skv, H, Hkv, hd, hd_v, seq_kv, window, causal,
               (float)(1.0 / sqrt((double)hd))};  // as the reference's scale
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, out, B, d, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, out, B, d, s);
    case 2: return launch<__half>(q, k, v, out, B, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
