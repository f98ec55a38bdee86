// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan (and its wrapper
// repro/kernels/ops.py:mamba2_ssd).  Layouts are the wrapper's, all f32 and
// contiguous: x [B, S, H, P], B and C [B, S, G, N], dt [B, S, H], A_log and D
// [H]; y [B, S, H, P].  Head h reads B and C of group h / (H / G): no repeated
// copy is made.
//
// What it computes, per (batch row, head) and per chunk of Q = min(chunk, S)
// positions, with A = -exp(A_log) and the state S [N, P] carried from chunk to
// chunk (zero before the first):
//   cum_i  = sum_{k <= i} dt_k A                         (within the chunk)
//   y_i    = exp(cum_i) C_i . S                           (inter-chunk)
//          + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//          + D x_i
//   S     <- exp(cum_Q) S + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
// The segment cum_i - cum_j is only ever exponentiated where i >= j (the
// reference clamps it to 0 before the exp; here the masked entries are never
// formed).  Positions past S in a ragged last chunk read as 0 and are not
// written.
//
// Grid: blockIdx.x the head, .y the batch row.  On the TPU the chunks were
// the sequential last grid axis with S in VMEM scratch; here one thread block
// owns its (batch row, head) and walks the chunks in a loop, with S in shared
// memory.  The Q x Q intra-chunk weight does not fit in shared memory at
// Q = 256 (256 KB in f32), so it is tiled: 64 rows i at a time, against the
// 64-row column tiles j at or below the diagonal; W = (C B^T) o L o dt for
// one 64 x 64 tile goes through shared memory into the W.x product, and the
// inter-chunk term starts each row tile's accumulator.  256 threads as a
// 16 x 16 grid: thread (ty, tx) owns rows ty + 16r (r < 4) of a row tile,
// columns tx + 16c (c < 4) of a W tile and columns tx + 16c (c < 8, so
// P <= 128) of the output.  The in-chunk cumulative sum is one warp's scan
// (a run per lane, then __shfl_up_sync over the lanes' totals).  Shared
// memory: S (N x P), C and B row tiles (64 x N, rows padded to an odd stride
// so the 16 rows a warp reads at one depth fall in 16 banks), an x tile
// (64 x P), the W tile, and dt and cum of the chunk: 83 KB at zamba2's
// N = P = 64, Q = 256, and 131 KB at mamba2-780m's N = 128.
//
// What bounds it on an H100: operations, in f32 (the reference's type).  At
// zamba2's prefill (B 2, S 4096, 80 heads of 64, N 64, Q 256) the lower
// triangles of C B^T and W x, the inter-chunk C S and the state update are
// 32 GFLOP against 0.34 GB moved: 0.48 ms at the 67 TFLOP/s of f32 outside
// the tensor cores, 0.10 ms of memory.  This first version runs the products
// from shared memory with one thread block per (batch row, head), 160 blocks
// at zamba2's shape, a little over one wave; splitting the chunks across
// blocks (the chunk-parallel form of SSD) and tensor-core products are later
// work.
//
// C interface (bound with ctypes): the entry point makes the given device
// current, launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 = success), or the error of a refused
// cudaFuncSetAttribute (too much shared memory).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;                    // rows of a row or column tile
constexpr int kThreads = 256;
constexpr int kMaxCols = 8;               // output columns a thread: P <= 128

struct Dims {
  int64_t S, H, P, G, N, Q;
};

size_t smem_bytes(int64_t N, int64_t P, int64_t Q) {
  return sizeof(float) *
         (N * P + 2 * kT * (N | 1) + kT * P + kT * (kT + 1) + 2 * Q);
}

// Stage rows [row0, row0 + rows) of head `head` of a [batch, S, heads, width]
// tensor into dst[r * ld + c]; the rest of the 64-row tile reads as 0.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int64_t b, int64_t S, int64_t row0,
                                          int rows, int64_t heads,
                                          int64_t head, int width) {
  for (int i = threadIdx.x; i < kT * width; i += kThreads) {
    const int r = i / width, c = i - r * width;
    dst[r * ld + c] =
        r < rows ? src[((b * S + row0 + r) * heads + head) * width + c] : 0.f;
  }
}

// cum[i] = sum_{k <= i} dt[k] * A for i < Q, by warp 0: each lane runs over
// its own stretch, then adds the lanes' totals before it.
__device__ __forceinline__ void chunk_cumsum(const float* dt, float* cum,
                                             int Q, float A) {
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32, start = lane * per;
  const int end = min(Q, start + per);
  float run = 0.f;
  for (int i = start; i < end; ++i) {
    run = __fadd_rn(run, __fmul_rn(dt[i], A));
    cum[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = 0.f;
  for (int i = start; i < end; ++i) cum[i] += before;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A_log, const float* __restrict__ Dp,
                float* __restrict__ y, Dims d) {
  extern __shared__ float smem[];
  const int N = (int)d.N, P = (int)d.P, Q = (int)d.Q;
  const int ldn = N | 1, ldw = kT + 1;
  float* sS = smem;                       // [N][P] state
  float* sC = sS + N * P;                 // [kT][ldn]
  float* sB = sC + kT * ldn;              // [kT][ldn]
  float* sX = sB + kT * ldn;              // [kT][P]
  float* sW = sX + kT * P;                // [kT][ldw]
  float* sCum = sW + kT * ldw;            // [Q]
  float* sDt = sCum + Q;                  // [Q]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t h = blockIdx.x, b = blockIdx.y;
  const int64_t g = h / (d.H / d.G);
  const float A = -expf(A_log[h]);
  const float Dh = Dp[h];

  for (int i = threadIdx.x; i < N * P; i += kThreads) sS[i] = 0.f;
  const int64_t nc = (d.S + Q - 1) / Q;
  const int nt = (Q + kT - 1) / kT;

  for (int64_t c = 0; c < nc; ++c) {
    const int64_t c0 = c * Q;
    const int len = (int)min((int64_t)Q, d.S - c0);   // valid rows of the chunk
    __syncthreads();                      // the last chunk's update is done
    for (int i = threadIdx.x; i < Q; i += kThreads)
      sDt[i] = i < len ? dt[(b * d.S + c0 + i) * d.H + h] : 0.f;
    __syncthreads();
    if (threadIdx.x < 32) chunk_cumsum(sDt, sCum, Q, A);
    __syncthreads();

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kT;
      const int irows = max(0, min(kT, len - i0));
      load_rows(sC, ldn, Cm, b, d.S, c0 + i0, irows, d.G, g, N);
      __syncthreads();

      // inter-chunk: y_i = exp(cum_i) C_i . S
      float acc[4][kMaxCols];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) acc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldn + n];
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int col = tx + 16 * k;
          if (col < P) {
            const float sv = sS[n * P + col];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(cv[r], sv, acc[r][k]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = i0 + ty + 16 * r;
        const float e = ii < Q ? expf(sCum[ii]) : 0.f;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) acc[r][k] *= e;
      }

      // intra-chunk: the column tiles at or below the diagonal
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        const int jrows = max(0, min(kT, len - j0));
        __syncthreads();                  // the last tile is done with sB, sX, sW
        load_rows(sB, ldn, Bm, b, d.S, c0 + j0, jrows, d.G, g, N);
        load_rows(sX, P, x, b, d.S, c0 + j0, jrows, d.H, h, P);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) w[r][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * ldn + n];
#pragma unroll
          for (int k = 0; k < 4; ++k) bv[k] = sB[(tx + 16 * k) * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < 4; ++k) w[r][k] = fmaf(cv[r], bv[k], w[r][k]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ii = i0 + ty + 16 * r;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int jj = j0 + tx + 16 * k;
            const float wv = (jj <= ii && ii < Q)
                                 ? w[r][k] * expf(sCum[ii] - sCum[jj]) * sDt[jj]
                                 : 0.f;
            sW[(ty + 16 * r) * ldw + tx + 16 * k] = wv;
          }
        }
        __syncthreads();
        for (int j = 0; j < kT; ++j) {
          float wv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = sW[(ty + 16 * r) * ldw + j];
#pragma unroll
          for (int k = 0; k < kMaxCols; ++k) {
            const int col = tx + 16 * k;
            if (col < P) {
              const float xv = sX[j * P + col];
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[r][k] = fmaf(wv[r], xv, acc[r][k]);
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ii = i0 + ty + 16 * r;
        if (ii >= len) continue;
        const int64_t row = ((b * d.S + c0 + ii) * d.H + h) * P;
#pragma unroll
        for (int k = 0; k < kMaxCols; ++k) {
          const int col = tx + 16 * k;
          if (col < P) y[row + col] = acc[r][k] + x[row + col] * Dh;
        }
      }
      __syncthreads();                    // sC and sS reads done
    }

    // state: S = exp(cum_Q) S + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
    const float cum_end = sCum[Q - 1];
    const float decay = expf(cum_end);
    for (int i = threadIdx.x; i < N * P; i += kThreads) sS[i] *= decay;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kT;
      const int jrows = max(0, min(kT, len - j0));
      __syncthreads();
      load_rows(sB, ldn, Bm, b, d.S, c0 + j0, jrows, d.G, g, N);
      load_rows(sX, P, x, b, d.S, c0 + j0, jrows, d.H, h, P);
      for (int j = threadIdx.x; j < kT; j += kThreads)
        sW[j] = j < jrows ? expf(cum_end - sCum[j0 + j]) * sDt[j0 + j] : 0.f;
      __syncthreads();
      for (int i = threadIdx.x; i < N * P; i += kThreads) {
        const int n = i / P, p = i - n * P;
        float s = sS[i];
        for (int j = 0; j < kT; ++j)
          s = fmaf(sB[j * ldn + n] * sW[j], sX[j * P + p], s);
        sS[i] = s;
      }
    }
  }
}

}  // namespace

extern "C" {

int ssd_scan_launch(const void* x, const void* Bm, const void* Cm,
                    const void* dt, const void* A_log, const void* D, void* y,
                    int64_t Bsz, int64_t S, int64_t H, int64_t P, int64_t G,
                    int64_t N, int64_t chunk, int device, void* stream) {
  if (Bsz < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 ||
      P > 16 * kMaxCols || N < 1 || chunk < 1 || Bsz > 65535 ||
      H > 2147483647 || N * P > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t Q = chunk < S ? chunk : S;
  const size_t smem = smem_bytes(N, P, Q);
  if (smem > (size_t)2147483647) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(ssd_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Dims d{S, H, P, G, N, Q};
  ssd_scan_kernel<<<dim3((unsigned)H, (unsigned)Bsz), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(D),
      static_cast<float*>(y), d);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
