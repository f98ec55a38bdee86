// Forward flash attention for Hopper (sm_90a): online softmax over key blocks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (and its GQA wrapper repro/kernels/ops.py:gqa_flash_attention).  Layouts are
// the wrapper's: q [B, Sq, H, hd], k [B, Skv, Hkv, hd], v [B, Skv, Hkv, hd_v],
// out [B, Sq, H, hd_v], all contiguous, in f32, bf16 or f16; every sum is
// taken in f32 and the output is rounded once to q's type.  Query head h
// reads kv head h / (H / Hkv): no repeated kv is made.
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
// On the TPU the key blocks were the sequential last grid axis with m, l,
// acc in VMEM scratch; here Hopper's blocks run in no order, so one thread
// block owns a block of 64 query rows of one (head, batch row) and walks the
// key blocks in a loop, with m, l and acc in registers.  Two kernels:
//
// flash_fwd_mma_kernel, bf16 and f16 with hd, hd_v <= 128, hd 192 with
// hd_v 128 (multi-head latent attention: 128 nope + 64 rope columns of q
// and k, 128 of v), or hd = hd_v = 160 (stablelm-12b), the model's path.
// Four warps, 16 query rows each.  Q is loaded once and kept in registers
// as mma A fragments; K and V tiles of 64 keys arrive through a ring of two
// stages in shared memory, filled by 16-byte cp.async copies, the next tile
// in flight while the current one is consumed.  Q.K^T and P.V are
// mma.sync.m16n8k16 with f32 accumulators, fed by ldmatrix (.trans for V)
// from rows padded by 16 bytes, so the eight rows of each 8 x 8 matrix fall
// in distinct banks.  The scores stay in registers: the online softmax takes
// row max and sum with quad shuffles and l from the f32 P; scores are kept
// in log2 units (scale times log2 e), so each exponential is one f32 exp2f.
// P enters the P.V product straight from the score accumulators, split as
// hi = bf16(P) (or f16) plus lo = bf16(P - hi): two mma per V fragment.  One
// rounding of P to bf16 misses the two-step output tolerance where the
// output is near 0; the split keeps ~16 bits of P, at 1.5x the products of a
// plain flash attention.  Q.K^T needs no split: a product of two bf16 values
// is exact in the f32 sum.  Ragged head widths (5, 40, 72, 80) are zero
// padded in shared memory to a multiple of 16; a row past the sequence
// reads as zero.  Causal query blocks are issued last block first, so the
// longest start first.  Heads of 64 and 80, MLA's 192/128 and heads of 160
// (stablelm-12b's) get kernels whose tile counts are compile-time
// constants; registers are bounded for three blocks an SM, or for two at
// MLA's widths and at 160, whose Q fragments (12 or 10 tiles of 16
// columns) and accumulators (16 or 20 tiles of 8) do not fit the
// three-block bound of ~170 registers; at 160 Q is read from shared
// memory each key block, as its 30 tiles in registers would spill.  MLA's
// two stages of K [64][200] and V [64][136] with Q [64][200] take 109 KB
// of shared memory, and 160's Q, K and V of [64][168] 107,520 B: two
// blocks an SM.
// Rows that are not a multiple of 8 elements, or operands not on 16-byte
// boundaries, take a plain load path into the same tiles.
//
// flash_fwd_simt_kernel, f32 (and bf16/f16 heads wider than 128 but the
// 192/128 and 160/160 pairs): products in f32 FMAs on the CUDA cores, from
// f32 copies of the tiles in shared memory.  A single TF32 pass cannot hold
// the f32 tolerance (2e-5).  256 threads as a 16 x 16 grid: thread (ty, tx)
// owns query rows ty + 16r (r < 4), the score columns tx + 16c (c < 4) of
// each 64-key block, and the output columns tx + 16c (c < NC): NC = 8 for
// hd_v <= 128, 10 for hd_v <= 160, so the narrower widths keep their
// registers.  A row's 16 owners sit in one half-warp and reduce its max
// and sum with __shfl_xor_sync.
//
// What bounds it on an H100: operations.  Causal attention at zamba2's
// prefill (B 2, S 4096, 32 heads of 80) is 172 GFLOP against 84 MB of q, k,
// v and out: 0.17 ms at the 989 TFLOP/s of bf16 tensor cores, 0.03 ms of
// memory.  The split P makes the tensor-core work 1.5x that (0.26 ms).
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
#include <type_traits>

namespace {

constexpr int kBQ = 64;                   // query rows per thread block
constexpr int kBK = 64;                   // keys per block of the loop
constexpr int kThreads = 256;
constexpr int kMaxCols = 10;              // output columns a thread: hd_v <= 160
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

// NC: output columns a thread (hd_v <= 16 NC).
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
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
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();                      // sP complete

    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = sP[(ty + 16 * r) * ldp + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
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
    for (int c = 0; c < NC; ++c) {
      const int64_t col = tx + 16 * c;
      if (col < d.hd_v) dst[col] = from_f32<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch_simt_nc(const void* q, const void* k, const void* v, void* out, int64_t B,
                   const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_bytes(d.hd, d.hd_v);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((d.Sq + kBQ - 1) / kBQ), (unsigned)d.H, (unsigned)B);
  flash_fwd_simt_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

// 8 output columns a thread up to hd_v 128, 10 above.
template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* out, int64_t B,
                const Dims& d, cudaStream_t stream) {
  return d.hd_v <= 128 ? launch_simt_nc<T, 8>(q, k, v, out, B, d, stream)
                       : launch_simt_nc<T, kMaxCols>(q, k, v, out, B, d, stream);
}


// ------------------------------------------------------ tensor-core kernel

constexpr int kMmaThreads = 128;          // 4 warps of 16 query rows
constexpr int kStages = 2;                // K/V ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, f32 accumulators (not volatile: the compiler may
// interleave independent products).
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <typename T2>
__device__ __forceinline__ uint32_t as_u32(T2 x) { return *reinterpret_cast<uint32_t*>(&x); }

// (x0, x1) rounded to bf16 (or f16) as two halves of one register, x0 in the
// low half; lo gets the remainders x - hi, rounded the same way.
template <typename T>
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = as_u32(h);
    lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    hi = as_u32(h);
    lo = as_u32(__floats2half2_rn(x0 - hf.x, x1 - hf.y));
  }
}

// Stage rows [row0, row0 + 64) of one head (row r at src + r * stride) into
// dst[r * ld + c], c < width; rows at or past `seq` read as 0.  vec: 16-byte
// cp.async copies (width a multiple of 8, all 16-byte aligned; the padding
// columns were zeroed once and are never written); else plain loads, which
// also write the padding columns up to wpad.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src,
                                          int64_t stride, int64_t row0, int64_t seq,
                                          int width, int wpad, bool vec) {
  if (vec) {
    const int cpr = width / 8;
    for (int i = threadIdx.x; i < kBK * cpr; i += kMmaThreads) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      const bool ok = row0 + r < seq;
      cp_async16(dst + r * ld + c, ok ? src + (row0 + r) * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * wpad; i += kMmaThreads) {
      const int r = i / wpad, c = i - r * wpad;
      dst[r * ld + c] = (row0 + r < seq && c < width) ? src[(row0 + r) * stride + c]
                                                      : from_f32<T>(0.f);
    }
  }
}

// KT: 16-column tiles of hd kept as Q fragments; NT: 8-column tiles of the
// output.  EXACT: hd and hd_v take exactly KT and NT tiles, so every loop has
// a compile-time count; else loops run to these bounds with runtime guards.
// Blocks an SM: three up to KT 8, two above.
template <typename T, int KT, int NT, bool EXACT>
__global__ void __launch_bounds__(kMmaThreads, KT > 8 ? 2 : 3)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, Dims d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = (int)d.hd, hd_v = (int)d.hd_v;
  const int kts = EXACT ? KT : (hd + 15) / 16;
  const int nts = EXACT ? NT : (hd_v + 15) / 16 * 2;
  const int ldq = kts * 16 + 8, ldv = nts * 8 + 8;     // +16 bytes a row
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kBQ * ldq;                               // [kStages][kBK][ldq]
  T* sV = sK + kStages * kBK * ldq;                     // [kStages][kBK][ldv]

  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t n_qb = gridDim.z;
  const int64_t qb = d.causal ? n_qb - 1 - blockIdx.z : blockIdx.z;
  const int64_t q0 = qb * kBQ;
  const int64_t kvh = h / (d.H / d.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r0 = q0 + warp * 16;                    // this warp's first row

  // Zero all tiles once: the padding columns stay zero.
  {
    const int n16 = (kBQ * ldq + kStages * kBK * (ldq + ldv)) * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += kMmaThreads)
      reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

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

  const T* qh = q + (b * d.Sq * d.H + h) * hd;
  const T* kh = k + (b * d.Skv * d.Hkv + kvh) * hd;
  const T* vh = v + (b * d.Skv * d.Hkv + kvh) * hd_v;
  load_rows(sQ, ldq, qh, d.H * hd, q0, d.Sq, hd, kts * 16, vec);
  load_rows(sK, ldq, kh, d.Hkv * hd, lo * kBK, d.Skv, hd, kts * 16, vec);
  load_rows(sV, ldv, vh, d.Hkv * hd_v, lo * kBK, d.Skv, hd_v, nts * 8, vec);
  cp_async_commit();

  // Q fragments (4 registers a 16-column tile) stay in registers beside the
  // output accumulators (4 a tile of 8) up to 28 tiles together (MLA's
  // 12 + 16 take 255 registers with no spill); above (160's 10 + 20) they
  // spill at the two-block bound, so Q is read again from shared memory
  // (10 ldmatrix a key block; 241 registers, no spill).
  constexpr bool QREG = KT + NT <= 28;
  uint32_t qf[QREG ? KT : 1][4];
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // scores in log2 units: exp(x) = exp2(x log2 e), so each p is one exp2
  const float scale_log2 = d.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // the warp's rows: past the end, or seeing no key of a block, skip it
  const bool rows_live = r0 < d.Sq;

  for (int64_t kb = lo; kb < hi; ++kb) {
    const int stage = (int)((kb - lo) & 1);
    if (kb + 1 < hi) {
      const int nx = stage ^ 1;
      load_rows(sK + nx * kBK * ldq, ldq, kh, d.Hkv * hd, (kb + 1) * kBK, d.Skv, hd,
                kts * 16, vec);
      load_rows(sV + nx * kBK * ldv, ldv, vh, d.Hkv * hd_v, (kb + 1) * kBK, d.Skv,
                hd_v, nts * 8, vec);
    }
    cp_async_commit();
    cp_async_wait_one();                  // this block's tile kb has landed
    __syncthreads();                      // ... and every thread's copies too
    if (QREG && kb == lo) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        if (kt < kts)
          ldsm_x4(qf[QREG ? kt : 0],
                  sQ + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldq +
                      kt * 16 + 8 * (lane >> 4));
    }
    const int64_t k0 = kb * kBK;
    bool skip = !rows_live || k0 >= d.seq_kv;
    bool full = k0 + kBK <= d.seq_kv;
    if (d.causal) {
      skip = skip || k0 > r0 + 15;
      full = full && k0 + kBK - 1 <= r0;
      if (d.window > 0) {
        skip = skip || r0 - (k0 + kBK - 1) >= d.window;
        full = full && r0 + 15 - k0 < d.window;
      }
    }
    if (!skip) {
      const T* tK = sK + stage * kBK * ldq;
      const T* tV = sV + stage * kBK * ldv;
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        if (kt < kts) {
          if (!QREG)
            ldsm_x4(qf[0], sQ + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldq +
                               kt * 16 + 8 * (lane >> 4));
          const uint32_t(&qa)[4] = qf[QREG ? kt : 0];
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bk[4];
            ldsm_x4(bk, tK + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * ldq + kt * 16 +
                            8 * ((lane >> 3) & 1));
            mma16816<T>(s[2 * np], qa, bk[0], bk[1]);
            mma16816<T>(s[2 * np + 1], qa, bk[2], bk[3]);
          }
        }
      }
      // scale, mask, and the online softmax of rows g (e < 2) and g + 8
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sv = s[j][e] * scale_log2;
          if (!full) {
            const int64_t qpos = r0 + g + 8 * (e >> 1);
            const int64_t kpos = k0 + j * 8 + 2 * t + (e & 1);
            bool seen = kpos < d.seq_kv;
            if (d.causal) {
              seen = seen && kpos <= qpos;
              if (d.window > 0) seen = seen && qpos - kpos < d.window;
            }
            if (!seen) sv = kNegInf;
          }
          s[j][e] = sv;
          mx[e >> 1] = fmaxf(mx[e >> 1], sv);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[j][e] = p;
        }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // P.V: the score accumulators of two 8-key tiles are the A fragment
      // of one 16-key step; hi and lo parts against the same V fragment
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ph[4], pl[4];
        split_pack<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_pack<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_pack<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_pack<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          if (2 * np < nts) {
            uint32_t bv[4];
            ldsm_x4_t(bv, tV + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ldv +
                              np * 16 + 8 * (lane >> 4));
            mma16816<T>(o[2 * np], pl, bv[0], bv[1]);
            mma16816<T>(o[2 * np], ph, bv[0], bv[1]);
            mma16816<T>(o[2 * np + 1], pl, bv[2], bv[3]);
            mma16816<T>(o[2 * np + 1], ph, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();                      // done with this stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qpos = r0 + g + 8 * r;
    if (qpos >= d.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* dst = out + ((b * d.Sq + qpos) * d.H + h) * hd_v;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (j < nts && col < hd_v) dst[col] = from_f32<T>(o[j][2 * r + e] * inv);
      }
  }
}

size_t mma_smem_bytes(int64_t hd, int64_t hd_v, size_t elem) {
  const int64_t ldq = (hd + 15) / 16 * 16 + 8, ldv = (hd_v + 15) / 16 * 16 + 8;
  return elem * (kBQ * ldq + kStages * kBK * (ldq + ldv));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, int KT, int NT, bool EXACT>
int launch_mma(const void* q, const void* k, const void* v, void* out, int64_t B,
               const Dims& d, cudaStream_t stream) {
  auto kernel = flash_fwd_mma_kernel<T, KT, NT, EXACT>;
  if ((d.Sq + kBQ - 1) / kBQ > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem_bytes(d.hd, d.hd_v, sizeof(T));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = d.hd % 8 == 0 && d.hd_v % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v);
  const dim3 grid((unsigned)d.H, (unsigned)B, (unsigned)((d.Sq + kBQ - 1) / kBQ));
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), d, vec);
  return (int)cudaGetLastError();
}

// MLA's widths: q and k heads of 177-192 (deepseek-v3's 192), v heads of
// 121-128, which the tensor-core kernel takes in 12 and 16 tiles.
bool mla_widths(int64_t hd, int64_t hd_v) {
  return (hd + 15) / 16 == 12 && (hd_v + 15) / 16 * 2 == 16;
}

// stablelm-12b's widths: q, k and v heads of 145-160 (its 160), which the
// tensor-core kernel takes in 10 and 20 tiles.
bool w160_widths(int64_t hd, int64_t hd_v) {
  return (hd + 15) / 16 == 10 && (hd_v + 15) / 16 * 2 == 20;
}

// The widths the tensor-core kernel takes.
bool tc_widths(int64_t hd, int64_t hd_v) {
  return (hd <= 128 && hd_v <= 128) || mla_widths(hd, hd_v) || w160_widths(hd, hd_v);
}

// The tensor-core kernel for hd, hd_v <= 128 and for MLA's and 160's
// widths: widths of 64 and 80 (the model zoo's), MLA's and 160 get kernels
// sized to them, any other the widest of hd, hd_v <= 128.
template <typename T>
int launch_tc(const void* q, const void* k, const void* v, void* out, int64_t B,
              const Dims& d, cudaStream_t stream) {
  const int64_t kts = (d.hd + 15) / 16, nts = (d.hd_v + 15) / 16 * 2;
  if (kts == 4 && nts == 8) return launch_mma<T, 4, 8, true>(q, k, v, out, B, d, stream);
  if (kts == 5 && nts == 10) return launch_mma<T, 5, 10, true>(q, k, v, out, B, d, stream);
  if (mla_widths(d.hd, d.hd_v))
    return launch_mma<T, 12, 16, true>(q, k, v, out, B, d, stream);
  if (w160_widths(d.hd, d.hd_v))
    return launch_mma<T, 10, 20, true>(q, k, v, out, B, d, stream);
  return launch_mma<T, 8, 16, false>(q, k, v, out, B, d, stream);
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
  const bool tc = tc_widths(hd, hd_v);
  switch (dtype) {
    case 0: return launch_simt<float>(q, k, v, out, B, d, s);
    case 1: return tc ? launch_tc<__nv_bfloat16>(q, k, v, out, B, d, s)
                      : launch_simt<__nv_bfloat16>(q, k, v, out, B, d, s);
    case 2: return tc ? launch_tc<__half>(q, k, v, out, B, d, s)
                      : launch_simt<__half>(q, k, v, out, B, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
