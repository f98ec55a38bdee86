// Mamba2 SSD chunked scan for Hopper (sm_90a), in the chunk-parallel form.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan (and its wrapper
// repro/kernels/ops.py:mamba2_ssd).  Layouts are the wrapper's, all f32 and
// contiguous: x [B, S, H, P], B and C [B, S, G, N], dt [B, S, H], A_log and D
// [H]; y [B, S, H, P].  Head h reads B and C of group h / (H / G): no repeated
// copy is made.  Three scratch tensors, allocated by the caller: cum
// [B, nc, Q, H], states [B, nc, H, N, P] (nc chunks of Q = min(chunk, S)) and
// cb [B, G, nc, pairs, 64, 64] (pairs: the 64-row tiles i >= j of a chunk).
//
// What it computes, per (batch row, head) and per chunk, with A = -exp(A_log)
// (the three phases of repro_torch/kernels/ssd_scan.py):
//   (1) states:  cum_i = sum_{k <= i} dt_k A           (within the chunk)
//                sloc  = sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T   [N, P]
//   (2) pass:    s_prev[c] = s;  s = s exp(cum_Q[c]) + sloc[c]  (s = 0 first),
//                written over sloc in place
//   (3) outputs: y_i = exp(cum_i) C_i . s_prev
//                    + sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//                    + D x_i
// The segment cum_i - cum_j is only exponentiated where j <= i (the reference
// clamps it to 0 before the exp; here the masked entries are never formed).
// Positions past S in a ragged last chunk read as 0 and are not written.
//
// Grid.  On the TPU the chunks were the sequential last grid axis with the
// state in VMEM scratch.  Here only phase (2) is sequential over chunks, and
// it is a short elementwise pass (one thread per state element, loading
// eight chunks ahead).  Phase (1) runs one block per (chunk, head, batch
// row), 2,560 blocks at zamba2's prefill (B 2, S 4096, 80 heads, Q 256).
// Phase (3) runs as two kernels: (3a) the 64 x 64 tiles C_i B_j^T, which
// depend on the group and not the head, once per (chunk, tile pair, group,
// batch row) -- 320 blocks for zamba2's one group, where every head would
// otherwise redo them; (3b) one block per (chunk, 64-row tile, head, batch
// row), 10,240 blocks, issued with the longest (last) row tiles of each
// chunk first.  Phases (1) and (3b) walk their 64-row tiles through two
// stages in shared memory filled by cp.async, the next tile in flight while
// the current one is used, with registers bounded for three blocks an SM.
//
// Products.  Every product -- B^T (w x) in (1), C B^T in (3a), C s_prev and
// W x in (3b) -- runs on the tensor cores as 3xTF32 mma.sync.m16n8k8: each
// f32 operand a is split into a TF32 high part (rounded) and the remainder,
// and acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps f32's accuracy
// (one TF32 pass, 10 bits of mantissa, misses the 1e-4 gate by far).  Each
// warp of 8 owns 16 x 32 output tiles; the four 8-column products of a step
// are issued in turn, so none waits on the last.  Operands are staged with
// row strides padded so that a warp's fragment reads fall in distinct banks,
// and an operand whose depth runs along its rows is read 8 bytes at a time.
// The 64 x 64 C B^T tile of (3b) becomes W in shared memory between its
// arrival and the W x product.
//
// What bounds it on an H100: operations.  At zamba2's prefill the lower
// triangles of C B^T and W x, C s_prev and the chunk states are 32.3 GFLOP
// against 0.34 GB of inputs and output: 0.48 ms at the 67 TFLOP/s of f32
// outside the tensor cores, and 3 x 32.3 GFLOP at 495 TFLOP/s of TF32 =
// 0.196 ms with the 3xTF32 split.  The chunk-parallel form moves more bytes
// than that (x twice, the 42 MB of states three times, about 0.2 ms).
//
// C interface (bound with ctypes): each entry point makes the given device
// current, launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 = success), or the error of a refused
// cudaFuncSetAttribute (too much shared memory).  ssd_scan_launch sets the
// shared memory of all its kernels before it launches any.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;                    // rows of a row or column tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Dims {
  int64_t B, S, H, P, G, N, Q, nc;
};

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// Row stride (floats) of a tile whose fragment reads walk 8 rows (g) at 4
// neighbouring columns (t): 4 * odd, so the 32 reads hit 32 banks.
__host__ __device__ __forceinline__ int ld_rows(int width) {
  return round_up(width, 8) + 4;
}
// Row stride of a tile whose fragment reads walk 4 rows (t) at 8
// neighbouring columns (g): 8 * odd.
__host__ __device__ __forceinline__ int ld_cols(int width) {
  return round_up(width, 16) + 8;
}

// Shared memory of phase (1): two stages of (B, x) row tiles, then w, dt
// and cum of the whole chunk.
size_t states_smem(const Dims& d) {
  return sizeof(float) *
         (2 * kT * (ld_rows(round_up((int)d.N, 16)) + ld_rows(round_up((int)d.P, 32))) +
          3 * d.Q);
}
// Phase (3): two stages, each a C B^T tile (made W in place) and an x
// tile; the C row tile and s_prev fill the second stage before the loop;
// then cum of the rows, and cum and dt of two stages of columns.
__host__ __device__ inline int outputs_stage(const Dims& d) {
  const int p32 = round_up((int)d.P, 32);
  const int wx = kT * (ld_cols(kT) + ld_rows(p32));
  const int cs = kT * ld_cols((int)d.N) + round_up((int)d.N, 8) * ld_rows(p32);
  return wx > cs ? wx : cs;
}
size_t outputs_smem(const Dims& d) {
  return sizeof(float) * (2 * (size_t)outputs_stage(d) + 5 * kT);
}
// Phase (3a): a C row tile and a B row tile.
size_t cb_smem(const Dims& d) { return sizeof(float) * 2 * kT * ld_cols((int)d.N); }
// Row-tile pairs (it, jt), jt <= it, of a chunk: the C B^T tiles phase (3) reads.
__host__ __device__ inline int64_t tile_pairs(int64_t Q) {
  const int64_t n = (Q + kT - 1) / kT;
  return n * (n + 1) / 2;
}

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away: the same as
// cvt.rna for finite x, without its checks for inf and NaN), lo = x - hi
// exactly, whose low 13 bits the tensor core ignores (lo is truncated to
// TF32 there: a relative error of 2^-21 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b (m16n8k8, TF32 in, f32 accumulators); not volatile, so the
// compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats at p and p + step; one 8-byte load when they are neighbours.
template <bool PAIR>
__device__ __forceinline__ float2 load2(const float* p, int step) {
  if constexpr (PAIR) return *reinterpret_cast<const float2*>(p);
  else return make_float2(p[0], p[step]);
}

// One warp: acc[nt] += A[m0:m0+16, 0:K] . B[0:K, n0+8nt : n0+8nt+8], nt < 4,
// in 3xTF32.  A(m, k) is a[m * lda + k] when AK (k runs along a row), else
// a[k * lda + m], times ascale[k] when given; B(k, n) is b[n * ldb + k] when
// BK, else b[k * ldb + n].  K is a multiple of 8 and the operands are zero
// past the true depth; all 32 columns are read (tiles are padded to them).
// Within each step of 8, the fragment's depths t and t + 4 are taken from
// the neighbouring depths 2t and 2t + 1 (a sum over k does not mind the
// order), so an operand whose k runs along its rows loads both with one
// 8-byte read.  Bank-conflict free when a row-of-k operand has a stride of
// 8 mod 16 and a column-of-k one a stride of 4 mod 8.  The products of the
// four column tiles are issued in turn, so that no product waits on the one
// before it.  The accumulator fragment of a lane (g = lane / 4, t = lane % 4):
// rows g and g + 8, columns 2t and 2t + 1.
template <bool AK, bool BK>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4][4], const float* a, int lda,
                                           const float* b, int ldb, int m0, int n0,
                                           int K, const float* ascale = nullptr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ak = AK ? 1 : lda, am = AK ? lda : 1;       // strides of k and m
  const int bk = BK ? 1 : ldb, bn = BK ? ldb : 1;
  const float* a0 = a + (m0 + g) * am + 2 * t * ak;
  const float* b0 = b + (n0 + g) * bn + 2 * t * bk;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float2 r0 = load2<AK>(a0 + k0 * ak, ak);             // row g
    const float2 r8 = load2<AK>(a0 + 8 * am + k0 * ak, ak);    // row g + 8
    float av[4] = {r0.x, r8.x, r0.y, r8.y};
    if (ascale) {
      const float2 sc = *reinterpret_cast<const float2*>(ascale + k0 + 2 * t);
      av[0] *= sc.x; av[1] *= sc.x; av[2] *= sc.y; av[3] *= sc.y;
    }
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(av[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float2 bv = load2<BK>(b0 + 8 * nt * bn + k0 * bk, bk);
      split(bv.x, bh[nt][0], bl[nt][0]);
      split(bv.y, bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], al, bh[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], ah, bl[nt]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[nt], ah, bh[nt]);
  }
}

template <int I>
__device__ __forceinline__ void zero(float (&acc)[I][4][4]) {
#pragma unroll
  for (int s = 0; s < I; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 (or, with size 4, 4) bytes from global to shared memory, in flight until
// the next wait; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Stage `rows` rows of `width` floats (row r at src + r * stride) into
// dst[r * ld + c] for c < wpad (a multiple of 4); rows at or past `valid` and
// columns at or past `width` read as 0.  vec (width, stride and src 16-byte
// aligned): 16-byte cp.async copies, landed at the next wait; else plain
// loads.
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int64_t stride, int rows, int valid,
                                           int width, int wpad, bool vec) {
  if (vec) {
    const int w4 = wpad / 4;
    for (int i = threadIdx.x; i < rows * w4; i += kThreads) {
      const int r = i / w4, c = (i - r * w4) * 4;
      const bool ok = r < valid && c < width;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * wpad; i += kThreads) {
      const int r = i / wpad, c = i - r * wpad;
      dst[r * ld + c] = r < valid && c < width ? src[r * stride + c] : 0.f;
    }
  }
}

// `n` floats src[i * stride], i < valid (else 0), into dst[i], by cp.async.
__device__ __forceinline__ void stage_column(float* dst, const float* __restrict__ src,
                                             int64_t stride, int n, int valid) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    cp_async4(dst + i, i < valid ? src + i * stride : src, i < valid);
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

// Phase (1).  Grid (chunk, head, batch row).  The N x P output is cut into
// items of 16 x 32 (a row tile of N, four column tiles of P), ITEMS a warp
// at a time; each batch of items sweeps the chunk's rows in tiles of 64,
// the next tile's copies in flight while the current one is consumed.
template <int ITEMS>
__global__ void __launch_bounds__(kThreads, 3)
ssd_states_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                  const float* __restrict__ dt, const float* __restrict__ A_log,
                  float* __restrict__ cum, float* __restrict__ states, Dims d,
                  int vec_x, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int N = (int)d.N, P = (int)d.P, Q = (int)d.Q;
  // B's rows are read as 16-row m tiles of A: padded to a multiple of 16
  const int ldb = ld_rows(round_up(N, 16)), ldx = ld_rows(round_up(P, 32));
  // two stages, each [kT][ldb] rows B_j (n) then [kT][ldx] rows x_j (p)
  const int stage_size = kT * (ldb + ldx);
  auto sB = [&](int u) { return smem + u * stage_size; };
  auto sX = [&](int u) { return smem + u * stage_size + kT * ldb; };
  float* sW = smem + 2 * stage_size;                      // [Q]: exp(cum_Q - cum_j) dt_j
  float* sDt = sW + Q;                                    // [Q]
  float* sCum = sDt + Q;                                  // [Q]

  const int64_t c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t grp = h / (d.H / d.G);
  const int64_t c0 = c * Q;
  const int len = (int)min((int64_t)Q, d.S - c0);
  const int ntiles = (len + kT - 1) / kT;
  const float* Bc = Bm + ((b * d.S + c0) * d.G + grp) * N;
  const float* xc = x + ((b * d.S + c0) * d.H + h) * P;
  auto stage = [&](int jt) {
    const int j0 = jt * kT, jrows = min(kT, len - j0);
    stage_tile(sB(jt & 1), ldb, Bc + j0 * d.G * N, d.G * N, kT, jrows, N,
               round_up(N, 16), vec_b);
    stage_tile(sX(jt & 1), ldx, xc + j0 * d.H * P, d.H * P, kT, jrows, P,
               round_up(P, 32), vec_x);
    cp_async_commit();
  };
  stage(0);

  const float A = -expf(A_log[h]);
  for (int i = threadIdx.x; i < Q; i += kThreads)
    sDt[i] = i < len ? dt[(b * d.S + c0 + i) * d.H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) chunk_cumsum(sDt, sCum, Q, A);
  __syncthreads();
  const float cum_end = sCum[Q - 1];
  for (int i = threadIdx.x; i < Q; i += kThreads) {
    cum[((b * d.nc + c) * Q + i) * d.H + h] = sCum[i];
    sW[i] = i < len ? expf(cum_end - sCum[i]) * sDt[i] : 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mts = (N + 15) / 16, groups = (P + 31) / 32, items = mts * groups;
  float* out = states + ((b * d.nc + c) * d.H + h) * d.N * d.P;
  for (int base = 0; base < items; base += ITEMS * kWarps) {
    if (base > 0) {
      __syncthreads();                    // the last batch is done with the tiles
      stage(0);
    }
    float acc[ITEMS][4][4];
    zero(acc);
    for (int jt = 0; jt < ntiles; ++jt) {
      cp_async_wait_all();
      __syncthreads();                    // tile jt landed; tile jt - 1 consumed
      if (jt + 1 < ntiles) stage(jt + 1);
      const int j0 = jt * kT;
      const int K = round_up(min(kT, len - j0), 8);
#pragma unroll
      for (int s = 0; s < ITEMS; ++s) {
        const int idx = base + warp + s * kWarps;
        if (idx < items) {
          const int mt = idx % mts, gr = idx / mts;
          mma_3xtf32<false, false>(acc[s], sB(jt & 1), ldb, sX(jt & 1), ldx, mt * 16,
                                   gr * 32, K, sW + j0);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      const int idx = base + warp + s * kWarps;
      if (idx >= items) continue;
      const int mt = idx % mts, gr = idx / mts;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = mt * 16 + g + (e >> 1) * 8;
          const int p = gr * 32 + nt * 8 + 2 * t + (e & 1);
          if (n < N && p < P) out[(int64_t)n * P + p] = acc[s][nt][e];
        }
    }
  }
}

// Phase (2).  Grid (state elements / 256, head, batch row); each thread walks
// the chunks of one state element, loading eight chunks ahead so that the
// loads are in flight together.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ cum, float* __restrict__ states,
                      Dims d) {
  constexpr int kAhead = 8;
  const int64_t NP = d.N * d.P;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  if (e >= NP) return;
  float* at = states + (b * d.nc * d.H + h) * NP + e;
  const float* cum_end = cum + (b * d.nc * d.Q + d.Q - 1) * d.H + h;
  const int64_t step = d.H * NP, cum_step = d.Q * d.H;
  float s = 0.f;
  for (int64_t c0 = 0; c0 < d.nc; c0 += kAhead) {
    float loc[kAhead], decay[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < d.nc) {
        loc[u] = at[(c0 + u) * step];
        decay[u] = cum_end[(c0 + u) * cum_step];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c0 + u < d.nc) {
        at[(c0 + u) * step] = s;
        s = __fadd_rn(__fmul_rn(s, expf(decay[u])), loc[u]);
      }
  }
}

// Phase (3a).  Grid (chunk x tile pair, group, batch row): the 64 x 64 tile
// C_i B_j^T of row tiles it >= jt of a chunk, shared by the group's heads,
// into cb [B, G, nc, pairs, 64, 64] (zero past the chunk's end); one 16 x 32
// item a warp.
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, Dims d, int vec_b) {
  extern __shared__ __align__(16) float smem[];
  const int N = (int)d.N, Q = (int)d.Q, ld = ld_cols(N), n8 = round_up(N, 8);
  float* sC = smem;                       // [kT][ld]: C_i, n
  float* sB = smem + kT * ld;             // [kT][ld]: B_j, n
  const int64_t pairs = tile_pairs(Q);
  const int64_t c = blockIdx.x / pairs, pr = blockIdx.x % pairs;
  const int64_t grp = blockIdx.y, b = blockIdx.z;
  int it = 0;
  while ((int64_t)(it + 1) * (it + 2) / 2 <= pr) ++it;
  const int jt = (int)(pr - (int64_t)it * (it + 1) / 2);
  const int64_t c0 = c * Q;
  const int len = (int)min((int64_t)Q, d.S - c0);
  const int irows = max(0, min(kT, len - it * kT)), jrows = max(0, min(kT, len - jt * kT));
  const float* Cc = Cm + ((b * d.S + c0) * d.G + grp) * N;
  const float* Bc = Bm + ((b * d.S + c0) * d.G + grp) * N;
  stage_tile(sC, ld, Cc + it * kT * d.G * N, d.G * N, kT, irows, N, n8, vec_b);
  stage_tile(sB, ld, Bc + jt * kT * d.G * N, d.G * N, kT, jrows, N, n8, vec_b);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wg = warp >> 2;
  float acc[1][4][4];
  zero(acc);
  mma_3xtf32<true, true>(acc[0], sC, ld, sB, ld, wm * 16, wg * 32, n8);
  float* out = cb + (((b * d.G + grp) * d.nc + c) * pairs + pr) * kT * kT;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (wm * 16 + g + 8 * r) * kT + wg * 32 + nt * 8 +
                                 2 * t) = make_float2(acc[0][nt][2 * r], acc[0][nt][2 * r + 1]);
}

// Phase (3).  Grid (chunk x row tile, head, batch row).  Output items are
// 16 x 32 of the 64 x P row tile, ITEMS a warp (2 for P > 64).  For each
// column tile j <= i, the C B^T tile of phase (3a) and the x tile come
// through two stages, the next one's copies in flight while the current one
// is used; the C B^T tile becomes W = (C B^T) o exp(cum_i - cum_j) o dt_j
// in place.
template <int ITEMS>
__global__ void __launch_bounds__(kThreads, 3)
ssd_outputs_kernel(const float* __restrict__ x, const float* __restrict__ Cm,
                   const float* __restrict__ dt, const float* __restrict__ Dp,
                   const float* __restrict__ cum, const float* __restrict__ states,
                   const float* __restrict__ cb, float* __restrict__ y, Dims d,
                   int vec_x, int vec_b, int vec_s) {
  extern __shared__ __align__(16) float smem[];
  const int N = (int)d.N, P = (int)d.P, Q = (int)d.Q;
  const int p32 = round_up(P, 32);       // x and s_prev padded to 32 columns
  const int ldc = ld_cols(N), ldx = ld_rows(p32), lds = ld_rows(p32), ldw = ld_cols(kT);
  const int n8 = round_up(N, 8);
  // two stages, each [kT][ldw] W_ij (j along rows) then [kT][ldx] x_j (p);
  // C_i [kT][ldc] and s_prev [n8][lds] fill the second before the loop
  const int stage_size = outputs_stage(d);
  auto sW = [&](int u) { return smem + u * stage_size; };
  auto sX = [&](int u) { return smem + u * stage_size + kT * ldw; };
  float* sC = smem + stage_size;
  float* sS = sC + kT * ldc;
  float* sCumI = smem + 2 * stage_size;               // [kT]
  auto sCumJ = [&](int u) { return sCumI + (1 + u) * kT; };   // [kT] a stage
  auto sDtJ = [&](int u) { return sCumI + (3 + u) * kT; };    // [kT] a stage

  const int ntl = (Q + kT - 1) / kT;
  const int64_t c = blockIdx.x / ntl;
  const int it = ntl - 1 - (int)(blockIdx.x % ntl);
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t grp = h / (d.H / d.G);
  const int64_t c0 = c * Q;
  const int len = (int)min((int64_t)Q, d.S - c0);
  const int i0 = it * kT;
  const int irows = min(kT, len - i0);
  if (irows <= 0) return;                 // a row tile past the ragged end

  const float* cum_c = cum + (b * d.nc + c) * Q * d.H + h;
  const float* xc = x + ((b * d.S + c0) * d.H + h) * P;
  const float* dtc = dt + (b * d.S + c0) * d.H + h;
  const float* cbc = cb + ((b * d.G + grp) * d.nc + c) * tile_pairs(Q) * kT * kT +
                     (int64_t)it * (it + 1) / 2 * kT * kT;
  auto stage = [&](int jt) {
    const int j0 = jt * kT, jrows = min(kT, len - j0), u = jt & 1;
    stage_tile(sW(u), ldw, cbc + jt * kT * kT, kT, kT, kT, kT, kT, true);
    stage_tile(sX(u), ldx, xc + j0 * d.H * P, d.H * P, kT, jrows, P, p32, vec_x);
    stage_column(sCumJ(u), cum_c + j0 * d.H, d.H, kT, jrows);
    stage_column(sDtJ(u), dtc + j0 * d.H, d.H, kT, jrows);
    cp_async_commit();
  };
  stage_tile(sC, ldc, Cm + ((b * d.S + c0 + i0) * d.G + grp) * N, d.G * N, kT, irows,
             N, n8, vec_b);
  stage_tile(sS, lds, states + ((b * d.nc + c) * d.H + h) * d.N * d.P, P, n8, N, P,
             p32, vec_s);
  stage_column(sCumI, cum_c + i0 * d.H, d.H, kT, irows);
  stage(0);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int items = 4 * (p32 / 32);
  float acc[ITEMS][4][4];
  zero(acc);
  // inter-chunk: exp(cum_i) C_i . s_prev
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int idx = warp + s * kWarps;
    if (idx < items) {
      const int mt = idx & 3, gr = idx >> 2;
      mma_3xtf32<true, false>(acc[s], sC, ldc, sS, lds, mt * 16, gr * 32, n8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[s][nt][e] *= expf(sCumI[mt * 16 + g + (e >> 1) * 8]);
    }
  }

  // intra-chunk: the column tiles at or below the diagonal
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT, jrows = min(kT, len - j0), u = jt & 1;
    cp_async_wait_all();
    __syncthreads();                      // tile jt landed; C, s_prev, tile jt - 1 used
    if (jt + 1 <= it) stage(jt + 1);
    float* w = sW(u);
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int i = e >> 6, j = e & (kT - 1);
      const bool seen = j0 + j <= i0 + i && i < irows && j < jrows;
      w[i * ldw + j] = seen ? w[i * ldw + j] * expf(sCumI[i] - sCumJ(u)[j]) * sDtJ(u)[j]
                            : 0.f;
    }
    __syncthreads();
    const bool diag = jt == it;
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      const int idx = warp + s * kWarps;
      if (idx < items) {
        const int mt = idx & 3, gr = idx >> 2;
        // on the diagonal, W rows of m tile mt are 0 past column 16 (mt + 1)
        const int K = diag ? min(round_up(jrows, 8), 16 * (mt + 1)) : round_up(jrows, 8);
        mma_3xtf32<true, false>(acc[s], w, ldw, sX(u), ldx, mt * 16, gr * 32, K);
      }
    }
  }

  const float Dh = Dp[h];
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int idx = warp + s * kWarps;
    if (idx >= items) continue;
    const int mt = idx & 3, gr = idx >> 2;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = mt * 16 + g + (e >> 1) * 8;
        const int p = gr * 32 + nt * 8 + 2 * t + (e & 1);
        if (i < irows && p < P) {
          const int64_t off = ((b * d.S + c0 + i0 + i) * d.H + h) * P + p;
          y[off] = acc[s][nt][e] + x[off] * Dh;
        }
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Validate the sizes and fill d; 0 or an error code.
int make_dims(Dims& d, int64_t Bsz, int64_t S, int64_t H, int64_t P, int64_t G,
              int64_t N, int64_t chunk, int device) {
  if (Bsz < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > 128 || N < 1 ||
      chunk < 1 || Bsz > 65535 || H > 65535 || N > 65536)
    return (int)cudaErrorInvalidValue;
  const int64_t Q = chunk < S ? chunk : S;
  const int64_t nc = (S + Q - 1) / Q;
  if (nc * tile_pairs(Q) > 2147483647 || G > 65535 || Q > 2147483647 / 4)
    return (int)cudaErrorInvalidValue;
  d = Dims{Bsz, S, H, P, G, N, Q, nc};
  return (int)cudaSetDevice(device);
}

int set_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)2147483647) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// Two items a warp where a batch of one a warp would not hold the output.
const void* states_kernel(const Dims& d) {
  const int64_t items = (d.N + 15) / 16 * ((d.P + 31) / 32);
  return items > kWarps ? (const void*)ssd_states_kernel<2>
                        : (const void*)ssd_states_kernel<1>;
}
const void* outputs_kernel(const Dims& d) {
  return d.P > 64 ? (const void*)ssd_outputs_kernel<2> : (const void*)ssd_outputs_kernel<1>;
}

void launch_states(const Dims& d, const float* x, const float* Bm, const float* dt,
                   const float* A_log, float* cum, float* states, cudaStream_t s) {
  const int vec_x = d.P % 4 == 0 && aligned16(x);
  const int vec_b = d.N % 4 == 0 && aligned16(Bm);
  const dim3 grid((unsigned)d.nc, (unsigned)d.H, (unsigned)d.B);
  if (states_kernel(d) == (const void*)ssd_states_kernel<2>)
    ssd_states_kernel<2><<<grid, kThreads, states_smem(d), s>>>(x, Bm, dt, A_log, cum,
                                                                 states, d, vec_x, vec_b);
  else
    ssd_states_kernel<1><<<grid, kThreads, states_smem(d), s>>>(x, Bm, dt, A_log, cum,
                                                                 states, d, vec_x, vec_b);
}

void launch_pass(const Dims& d, const float* cum, float* states, cudaStream_t s) {
  const int64_t blocks = (d.N * d.P + kThreads - 1) / kThreads;
  ssd_state_pass_kernel<<<dim3((unsigned)blocks, (unsigned)d.H, (unsigned)d.B),
                          kThreads, 0, s>>>(cum, states, d);
}

// Phase (3): the C B^T tiles of each group (3a), then the outputs.
void launch_outputs(const Dims& d, const float* x, const float* Bm, const float* Cm,
                    const float* dt, const float* D, const float* cum,
                    const float* states, float* cb, float* y, cudaStream_t s) {
  const int vec_x = d.P % 4 == 0 && aligned16(x);
  const int vec_b = d.N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const int vec_s = d.P % 4 == 0 && aligned16(states);
  ssd_cb_kernel<<<dim3((unsigned)(d.nc * tile_pairs(d.Q)), (unsigned)d.G, (unsigned)d.B),
                  kThreads, cb_smem(d), s>>>(Bm, Cm, cb, d, vec_b);
  const int64_t tiles = d.nc * ((d.Q + kT - 1) / kT);
  const dim3 grid((unsigned)tiles, (unsigned)d.H, (unsigned)d.B);
  if (outputs_kernel(d) == (const void*)ssd_outputs_kernel<2>)
    ssd_outputs_kernel<2><<<grid, kThreads, outputs_smem(d), s>>>(
        x, Cm, dt, D, cum, states, cb, y, d, vec_x, vec_b, vec_s);
  else
    ssd_outputs_kernel<1><<<grid, kThreads, outputs_smem(d), s>>>(
        x, Cm, dt, D, cum, states, cb, y, d, vec_x, vec_b, vec_s);
}

int set_outputs_smem(const Dims& d) {
  const int err = set_smem((const void*)ssd_cb_kernel, cb_smem(d));
  return err ? err : set_smem(outputs_kernel(d), outputs_smem(d));
}

}  // namespace

extern "C" {

// The whole scan: phases (1), (2), (3) on one stream.  cum [B, nc, Q, H],
// states [B, nc, H, N, P] and cb [B, G, nc, pairs, 64, 64] are scratch of
// the caller's.
int ssd_scan_launch(const void* x, const void* Bm, const void* Cm,
                    const void* dt, const void* A_log, const void* D, void* y,
                    void* cum, void* states, void* cb, int64_t Bsz, int64_t S,
                    int64_t H, int64_t P, int64_t G, int64_t N, int64_t chunk,
                    int device, void* stream) {
  Dims d;
  int err = make_dims(d, Bsz, S, H, P, G, N, chunk, device);
  if (err) return err;
  if ((err = set_smem(states_kernel(d), states_smem(d)))) return err;
  if ((err = set_outputs_smem(d))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_states(d, (const float*)x, (const float*)Bm, (const float*)dt,
                (const float*)A_log, (float*)cum, (float*)states, s);
  if ((err = (int)cudaGetLastError())) return err;
  launch_pass(d, (const float*)cum, (float*)states, s);
  if ((err = (int)cudaGetLastError())) return err;
  launch_outputs(d, (const float*)x, (const float*)Bm, (const float*)Cm,
                 (const float*)dt, (const float*)D, (const float*)cum,
                 (const float*)states, (float*)cb, (float*)y, s);
  return (int)cudaGetLastError();
}

// Phase (1) alone: cum and the chunk-local states.
int ssd_chunk_states_launch(const void* x, const void* Bm, const void* dt,
                            const void* A_log, void* cum, void* states,
                            int64_t Bsz, int64_t S, int64_t H, int64_t P,
                            int64_t G, int64_t N, int64_t chunk, int device,
                            void* stream) {
  Dims d;
  int err = make_dims(d, Bsz, S, H, P, G, N, chunk, device);
  if (err) return err;
  if ((err = set_smem(states_kernel(d), states_smem(d)))) return err;
  launch_states(d, (const float*)x, (const float*)Bm, (const float*)dt,
                (const float*)A_log, (float*)cum, (float*)states,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Phase (2) alone: the chunk-local states become the states entering each
// chunk, in place.
int ssd_state_pass_launch(const void* cum, void* states, int64_t Bsz, int64_t S,
                          int64_t H, int64_t P, int64_t G, int64_t N,
                          int64_t chunk, int device, void* stream) {
  Dims d;
  int err = make_dims(d, Bsz, S, H, P, G, N, chunk, device);
  if (err) return err;
  launch_pass(d, (const float*)cum, (float*)states, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Phase (3) alone: y from the inputs, cum and the states entering each chunk
// (cb is scratch).
int ssd_chunk_outputs_launch(const void* x, const void* Bm, const void* Cm,
                             const void* dt, const void* D, const void* cum,
                             const void* states, void* cb, void* y, int64_t Bsz,
                             int64_t S, int64_t H, int64_t P, int64_t G,
                             int64_t N, int64_t chunk, int device,
                             void* stream) {
  Dims d;
  int err = make_dims(d, Bsz, S, H, P, G, N, chunk, device);
  if (err) return err;
  if ((err = set_outputs_smem(d))) return err;
  launch_outputs(d, (const float*)x, (const float*)Bm, (const float*)Cm,
                 (const float*)dt, (const float*)D, (const float*)cum,
                 (const float*)states, (float*)cb, (float*)y,
                 static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
