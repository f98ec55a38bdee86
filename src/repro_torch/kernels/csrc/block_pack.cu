// Round-step kernels of the n-block circulant collectives, for Hopper (sm_90a).
//
// Buffers are [R, nslots, bs] row-major tensors (one row per rank), messages
// [R, bs], slot vectors [R] int32.  The broadcast-family kernels (pack,
// unpack, shuffle, shuffle_staged) only move data, so they are
// dtype-agnostic: a block of bs elements is a run of row_bytes = bs * itemsize
// bytes, copied in units of U bytes.  U is the widest of 16, 8, 4, 2, 1 that
// divides row_bytes and every base pointer; since every block starts at a
// multiple of row_bytes from its base, every load and store is then aligned.
// 16-byte units give one 128-bit load and store per thread per step (the
// broadcast path's f32 blocks of 289,264 bytes take them).  Copies are
// bit-exact by construction, whatever the element type.
//
// Grid: blockIdx.x is the row r (up to 2^31 - 1 rows), blockIdx.y a chunk of
// the row; the chunks of a row stride through it together.  Each thread block
// reads its row's slot index itself (no scalar prefetch as on the TPU), and
// traps on an index outside [0, nslots) rather than touch another row.
// All six data-plane kernels (the four copies and the two accumulating
// steps) take another grid for rows of fewer than 32 units (see "short
// rows" below); the launcher chooses by the units alone.  Every launcher
// takes its route, unit and grid from one function, launch_shape (see
// "launch shape" below), which the C interface exports.
//
// What bounds them on an H100: bytes.  They do no arithmetic, so the least
// time is the bytes they must move over the 3.35 TB/s of device memory:
// pack and unpack read one block and write one block per row
// (2 * R * row_bytes), shuffle reads two and writes two (4 * R * row_bytes,
// less one row transfer for each row whose two slots coincide).
// The simple design answers that with wide, coalesced, aligned accesses and
// enough thread blocks (R x chunks) to keep every SM's loads in flight; it
// does not stage through shared memory, since each byte is touched once.
// At short rows most of such a block idles, so pack, unpack, shuffle,
// shuffle_staged and the two accumulating kernels each have a short-row
// kernel that packs many rows into each warp instead.  TMA bulk copies and
// warp specialisation are later work.
//
// C interface (bound with ctypes): each entry point makes the given device
// current, launches on the given stream (the caller's PyTorch stream), does
// not synchronise, and returns cudaGetLastError() (0 = success);
// block_pack_launch_shape reports the shape a launch would take.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;  // each thread block covers 256 * 4 units
constexpr int64_t kMaxChunks = 65535;  // gridDim.y limit
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ int64_t load_slot(const int32_t* idx, int64_t r,
                                             int64_t nslots) {
  const int64_t s = idx[r];
  if (s < 0 || s >= nslots) __trap();
  return s;
}

// Replaces the TPU kernel repro/kernels/block_pack.py:block_pack (gather):
// out[r] = buf[r, idx[r]].  Rows of 32 units or more; shorter rows take
// pack_short_kernel.
template <typename V>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const V* __restrict__ buf, const int32_t* __restrict__ idx,
            V* __restrict__ out, int64_t nslots, int64_t units) {
  const int64_t r = blockIdx.x;
  const V* src = buf + (r * nslots + load_slot(idx, r, nslots)) * units;
  V* dst = out + r * units;
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j < units;
       j += stride)
    dst[j] = src[j];
}

// Replaces the TPU kernel repro/kernels/block_pack.py:block_unpack (scatter,
// in place): buf[r, idx[r]] = msg[r]; every other slot keeps its contents.
// Rows of 32 units or more; shorter rows take unpack_short_kernel.
template <typename V>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(V* __restrict__ buf, const V* __restrict__ msg,
              const int32_t* __restrict__ idx, int64_t nslots, int64_t units) {
  const int64_t r = blockIdx.x;
  V* dst = buf + (r * nslots + load_slot(idx, r, nslots)) * units;
  const V* src = msg + r * units;
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j < units;
       j += stride)
    dst[j] = src[j];
}

// Replaces the TPU kernel repro/kernels/block_pack.py:block_shuffle (fused
// unpack of round t + pack of round t+1, in place):
//   buf[r, recv[r]] = msg[r];  out[r] = buf[r, send[r]] read AFTER that write.
// Each element j of row r is handled by exactly one thread, which reads the
// pre-update buf[r, send[r], j] before it writes buf[r, recv[r], j].  That is
// the post-update value too: when recv[r] != send[r] the two blocks are
// distinct and never alias, so the write does not change the block read;
// when recv[r] == send[r] the post-update block IS msg[r], so the thread
// takes msg[r, j] and reads nothing from buf.  No thread reads an element
// another thread writes, so there is no cross-thread hazard and no barrier.
// msg and out must not overlap buf or each other.  Rows of 32 units or more;
// shorter rows take shuffle_short_kernel, with the same ownership.
// repro_torch/analysis/kernelaudit.py checks this ownership: it replays the
// record of each kernel (KERNEL_AUDITS in kernels/block_pack.py) over every
// thread of a launch with the cached slot tables (no element written by two
// threads, none read by a thread other than its writer, every output
// element written), and on the card holds the record's write set to the
// elements a launch changes and its grid to launch_shape's.
template <typename V>
__global__ void __launch_bounds__(kThreads)
shuffle_kernel(V* buf, const V* __restrict__ msg,
               const int32_t* __restrict__ recv,
               const int32_t* __restrict__ send, V* __restrict__ out,
               int64_t nslots, int64_t units) {
  const int64_t r = blockIdx.x;
  const int64_t rs = load_slot(recv, r, nslots);
  const int64_t ss = load_slot(send, r, nslots);
  V* row = buf + r * nslots * units;
  V* rdst = row + rs * units;
  const V* ssrc = row + ss * units;
  const V* m = msg + r * units;
  V* o = out + r * units;
  const bool same = rs == ss;
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j < units;
       j += stride) {
    const V v = m[j];
    const V s = same ? v : ssrc[j];
    rdst[j] = v;
    o[j] = s;
  }
}

// Replaces the TPU kernel repro/kernels/block_pack.py:block_shuffle_staged
// (the overlapped round loop's shuffle, in place):
//   buf[r, recv[r]] = msg[r];  out[r] = recv[r] == send[r] ? msg[r] : pre[r],
// where pre is round t+1's send block, packed from the buffer before round
// t's delivery landed.  The update changes only the recv block, so pre is
// stale exactly when send == recv, and then the message is the answer.  The
// kernel never reads buf, so no element is read after another thread's write.
// Bytes: per row it reads msg and (unless the slots coincide) pre, and writes
// buf[recv] and out: (4 * R - #{recv == send}) * row_bytes.  The simple
// design is the shuffle's: one thread per unit, wide aligned unit copies.
// msg, pre and out must not overlap buf or each other.  Rows of 32 units or
// more; shorter rows take shuffle_staged_short_kernel.  The ownership is
// checked by the audit named at shuffle_kernel.
template <typename V>
__global__ void __launch_bounds__(kThreads)
shuffle_staged_kernel(V* __restrict__ buf, const V* __restrict__ msg,
                      const V* __restrict__ pre,
                      const int32_t* __restrict__ recv,
                      const int32_t* __restrict__ send, V* __restrict__ out,
                      int64_t nslots, int64_t units) {
  const int64_t r = blockIdx.x;
  const int64_t rs = load_slot(recv, r, nslots);
  const bool same = rs == load_slot(send, r, nslots);
  V* rdst = buf + (r * nslots + rs) * units;
  const V* m = msg + r * units;
  const V* pr = pre + r * units;
  V* o = out + r * units;
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j < units;
       j += stride) {
    const V v = m[j];
    rdst[j] = v;
    o[j] = same ? v : pr[j];
  }
}

// ------------------------------------------------------------ short rows
//
// A row of fewer than kShortUnits units cannot fill a thread block of its
// own: the allgather's and the reduce_scatter's 192-byte rows are 12 units
// of 16 bytes, so the row x chunk grid above ran 1.33 M blocks of 12 (the
// accumulating kernels, with units of one element: 48) busy threads each,
// and scheduling blocks, not bytes, set the pace of all six data-plane
// kernels (15 % of their bytes bound on an H100).  Their bound is still
// bytes; the short-row kernels (pack, unpack, shuffle, shuffle_staged, and
// acc_shuffle_short_kernel below for the two accumulating steps) give no
// row a block.  Thread i of the flat range [0, rows * units) takes unit
// j = i mod units of row r = i / units (one 32-bit division), so a warp
// covers 32 consecutive units of consecutive rows, with no idle lane; its
// accesses of msg, pre and out, which are [rows, units] contiguous,
// coalesce fully, and each row's run of the buffer is units * U
// contiguous bytes.  Neighbouring threads read the same slot index, one
// L1 line for up to 32 rows.  A grid of a few resident blocks an SM walks
// the range grid-stride; each thread loads kShortK units (kShortK
// independent chains of index load, then data load) before it stores any,
// to keep enough bytes in flight.  Ownership is as above: each unit
// (r, j) belongs to one thread, which reads before it writes (checked by
// the audit named at shuffle_kernel).
// A launch covers at most kSlabRows rows, so every flat index fits in 31
// bits; the launcher walks longer buffers slab by slab.
constexpr int64_t kShortUnits = 32;
constexpr int kShortK = 4;
constexpr int64_t kSlabRows = int64_t(1) << 26;  // kSlabRows * 31 < 2^31

// pack, with pack_kernel's semantics: out[r] = buf[r, idx[r]].
template <typename V>
__global__ void __launch_bounds__(kThreads)
pack_short_kernel(const V* __restrict__ buf, const int32_t* __restrict__ idx,
                  V* __restrict__ out, int64_t nslots, uint32_t units,
                  uint32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < total;
       i0 += stride * kShortK) {
    V v[kShortK];
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        const uint32_t r = i / units;
        v[k] = buf[((int64_t)r * nslots + load_slot(idx, r, nslots)) * units +
                   (i - r * units)];
      }
    }
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) out[i] = v[k];
    }
  }
}

// unpack, with unpack_kernel's semantics: buf[r, idx[r]] = msg[r].  Rows
// that name the same slot index are still distinct addresses, and the
// kernel never reads buf.
template <typename V>
__global__ void __launch_bounds__(kThreads)
unpack_short_kernel(V* __restrict__ buf, const V* __restrict__ msg,
                    const int32_t* __restrict__ idx, int64_t nslots,
                    uint32_t units, uint32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < total;
       i0 += stride * kShortK) {
    V v[kShortK];
    int64_t dst[kShortK];
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        const uint32_t r = i / units;
        v[k] = msg[i];
        dst[k] = ((int64_t)r * nslots + load_slot(idx, r, nslots)) * units +
                 (i - r * units);
      }
    }
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      if (i0 + k * stride < total) buf[dst[k]] = v[k];
    }
  }
}

// shuffle, with shuffle_kernel's semantics: the thread that owns (r, j)
// takes msg when the slots coincide, else reads buf[r, send] before it
// writes buf[r, recv].
template <typename V>
__global__ void __launch_bounds__(kThreads)
shuffle_short_kernel(V* buf, const V* __restrict__ msg,
                     const int32_t* __restrict__ recv,
                     const int32_t* __restrict__ send, V* __restrict__ out,
                     int64_t nslots, uint32_t units, uint32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < total;
       i0 += stride * kShortK) {
    V v[kShortK], s[kShortK];
    int64_t dst[kShortK];
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        const uint32_t r = i / units;
        const int64_t j = i - r * units;
        const int64_t row = (int64_t)r * nslots;
        const int64_t rs = load_slot(recv, r, nslots);
        const int64_t ss = load_slot(send, r, nslots);
        v[k] = msg[i];
        s[k] = rs == ss ? v[k] : buf[(row + ss) * units + j];
        dst[k] = (row + rs) * units + j;
      }
    }
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        buf[dst[k]] = v[k];
        out[i] = s[k];
      }
    }
  }
}

// staged shuffle, with shuffle_staged_kernel's semantics: reads nothing
// of buf.
template <typename V>
__global__ void __launch_bounds__(kThreads)
shuffle_staged_short_kernel(V* __restrict__ buf, const V* __restrict__ msg,
                            const V* __restrict__ pre,
                            const int32_t* __restrict__ recv,
                            const int32_t* __restrict__ send,
                            V* __restrict__ out, int64_t nslots,
                            uint32_t units, uint32_t total) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < total;
       i0 += stride * kShortK) {
    V v[kShortK], s[kShortK];
    int64_t dst[kShortK];
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        const uint32_t r = i / units;
        const int64_t rs = load_slot(recv, r, nslots);
        v[k] = msg[i];
        s[k] = rs == load_slot(send, r, nslots) ? v[k] : pre[i];
        dst[k] = ((int64_t)r * nslots + rs) * units + (i - r * units);
      }
    }
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        buf[dst[k]] = v[k];
        out[i] = s[k];
      }
    }
  }
}

// ------------------------------------------------------------ launch shape
//
// The grid choice of all seven kernels is this one function: every
// *_launch below takes its route, unit and grid from launch_shape and
// launches exactly that, and block_pack_launch_shape exports it, so the
// audit (repro_torch/analysis/kernelaudit.py) can hold each kernel's
// Python record (kernels/block_pack.py) to the compiled launcher.
enum Kernel {
  kPack = 0, kUnpack, kShuffle, kShuffleStaged, kAccShuffle,
  kAccShuffleStaged, kQaccShuffle
};
enum Route { kRowChunk = 0, kShortRows = 1, kWarpBlock = 2 };

struct LaunchShape {
  int64_t route;     // Route
  int64_t unit;      // bytes a thread moves per access of buf (qacc: V floats)
  int64_t units;     // units a row (qacc: a quantization block)
  int64_t grid_x, grid_y, block;
  int64_t steps;     // units a thread loads before it stores (qacc: K)
  int64_t launches;  // launches (short rows: slabs of kSlabRows rows)
  int64_t resident;  // short rows: the grid's cap, blocks resident at once
};
constexpr int kShapeFields = 9;

int unit_bytes(int64_t row_bytes, uintptr_t pointers_or) {
  for (int w = 16; w > 1; w /= 2)
    if (row_bytes % w == 0 && pointers_or % w == 0) return w;
  return 1;
}

dim3 grid_for(int64_t R, int64_t units) {
  const int64_t per_block = (int64_t)kThreads * kUnitsPerThread;
  int64_t chunks = (units + per_block - 1) / per_block;
  if (chunks > kMaxChunks) chunks = kMaxChunks;
  return dim3((unsigned)R, (unsigned)chunks, 1);
}

// Blocks of the short-row grid for `rows` rows: kShortK units a thread,
// at most `resident` blocks (0: no cap).
int64_t short_grid(int64_t rows, int64_t units, int64_t resident) {
  const int64_t per_block = (int64_t)kThreads * kShortK;
  const int64_t grid = (rows * units + per_block - 1) / per_block;
  return resident > 0 && grid > resident ? resident : grid;
}

// size: a row's bytes (qacc: bs, its elements); qb: qacc's quantization
// block; itemsize: the accumulating kernels' element bytes; ptrs: the OR of
// the addresses whose alignment picks the unit (qacc: buf | err), qptrs
// qacc's int8 ones (qmsg | outq); resident: as in LaunchShape.
LaunchShape launch_shape(int kernel, int64_t R, int64_t size, int64_t qb,
                         int64_t itemsize, uintptr_t ptrs, uintptr_t qptrs,
                         int64_t resident) {
  LaunchShape s{kRowChunk, 1, 0, 0, 1, kThreads, 1, 1, 0};
  if (kernel == kQaccShuffle) {
    const int64_t V = qb % 4 == 0 && ptrs % 16 == 0 && qptrs % 4 == 0 ? 4 : 1;
    s.route = kWarpBlock;
    s.unit = 4 * V;
    s.units = qb / V;
    s.steps = s.units <= 32 ? 1 : s.units <= 64 ? 2 : s.units <= 128 ? 4 : 8;
    s.grid_x = (R * (size / qb) + kWarpsPerBlock - 1) / kWarpsPerBlock;
    return s;
  }
  if (kernel == kAccShuffle || kernel == kAccShuffleStaged) {
    // the short rows go in packs of 16 bytes where the row and pointers
    // allow; the row x chunk kernel goes element by element
    const int64_t bs = size / itemsize;
    const int64_t n = size % 16 == 0 && ptrs % 16 == 0 ? 16 / itemsize : 1;
    const bool short_row = bs / n < kShortUnits;
    s.unit = short_row ? n * itemsize : itemsize;
    s.units = short_row ? bs / n : bs;
    s.steps = kUnitsPerThread;
  } else {
    s.unit = unit_bytes(size, ptrs);
    s.units = size / s.unit;
  }
  if (s.units < kShortUnits) {
    s.route = kShortRows;
    s.steps = kShortK;
    s.grid_x = short_grid(R < kSlabRows ? R : kSlabRows, s.units, resident);
    s.launches = (R + kSlabRows - 1) / kSlabRows;
    s.resident = resident;
  } else {
    const dim3 g = grid_for(R, s.units);
    s.grid_x = g.x;
    s.grid_y = g.y;
  }
  return s;
}

// Set by block_pack_launch_shape: a launcher then writes the shape it would
// launch with here, and launches nothing.
thread_local LaunchShape* t_dry = nullptr;

// Launches a row x chunk or warp grid, or records it in a dry run.
template <typename F>
int launch_grid(const LaunchShape& sh, F launch) {
  if (t_dry) {
    *t_dry = sh;
    return 0;
  }
  launch(dim3((unsigned)sh.grid_x, (unsigned)sh.grid_y, 1));
  return (int)cudaGetLastError();
}

// Calls launch(r0, total, grid) for each slab of at most kSlabRows rows
// (total = its rows * units), with the short-row grid capped at as many
// blocks as fit on the SMs at once (`per_sm`, asked of the runtime once a
// kernel); returns the first error.  A dry run records the first slab's.
template <typename Kernel, typename F>
int by_slabs(Kernel kernel, std::atomic<int>& per_sm, LaunchShape sh,
             int64_t R, F launch) {
  int occ = per_sm.load(std::memory_order_relaxed);
  if (occ < 1) {
    if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, kernel, kThreads, 0))
      return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    per_sm.store(occ, std::memory_order_relaxed);
  }
  int dev = 0, sms = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  sh.resident = (int64_t)sms * occ;
  sh.grid_x = short_grid(R < kSlabRows ? R : kSlabRows, sh.units, sh.resident);
  if (t_dry) {
    *t_dry = sh;
    return 0;
  }
  for (int64_t r0 = 0; r0 < R; r0 += kSlabRows) {
    const int64_t rows = R - r0 < kSlabRows ? R - r0 : kSlabRows;
    launch(r0, (uint32_t)(rows * sh.units),
           (unsigned)short_grid(rows, sh.units, sh.resident));
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  return 0;
}

// ------------------------------------------------- the reduce family's ops
//
// The accumulating kernels do arithmetic, so they are typed: one
// instantiation per element type T and op (0 = sum, 1 = max).  What each
// computes must equal the plain PyTorch version (kernels/reduce_ops.py) bit
// for bit, and through it the JAX package's combine:
//  * sum: one correctly rounded add in T.  float and double add natively;
//    __half and __nv_bfloat16 add in float and round once (float's 24 bits
//    hold twice their precision plus two, so this is the correctly rounded
//    sum, as torch computes it).  Integers add in the unsigned type and
//    convert back: two's-complement wrap, where signed overflow would be
//    undefined.  The library is built without -ftz and --use_fast_math, so
//    denormals are kept, as torch's CUDA ops keep them.
//  * max: written out, never fmaxf/fmax/__hmax, whose NaN and signed-zero
//    choices are not XLA's: a NaN operand is returned itself (b's first, as
//    XLA on the CPU returns it);
//    equal operands give a unless a carries the sign bit (then b), so
//    max(-0, +0) = max(+0, -0) = +0; otherwise the larger.  Half types
//    compare in float and return an operand's own bits.
//  * identity: 0 for sum; -inf for floating max, the type's minimum for
//    integer max.  The drained slot is written with it by the kernel.

template <typename T> struct Num;  // integer types: wrap-around arithmetic

#define INT_NUM(T, U, MIN)                                                   \
  template <> struct Num<T> {                                                \
    static __device__ __forceinline__ T add(T a, T b) {                      \
      return (T)(U)((U)a + (U)b);                                            \
    }                                                                        \
    static __device__ __forceinline__ T max(T a, T b) { return a < b ? b : a; } \
    static __device__ __forceinline__ T lowest() { return MIN; }             \
    static __device__ __forceinline__ T zero() { return 0; }                 \
  };
INT_NUM(int8_t, uint8_t, INT8_MIN)
INT_NUM(int16_t, uint16_t, INT16_MIN)
INT_NUM(int32_t, uint32_t, INT32_MIN)
INT_NUM(int64_t, uint64_t, INT64_MIN)
#undef INT_NUM

__device__ __forceinline__ bool negative(float x) {
  return (__float_as_uint(x) >> 31) != 0;
}
__device__ __forceinline__ bool negative(double x) {
  return __double_as_longlong(x) < 0;
}

template <typename T, typename F>
__device__ __forceinline__ T float_max(T a, T b, F fa, F fb) {
  if (fb != fb) return b;
  if (fa != fa) return a;
  if (fa == fb) return negative(fa) ? b : a;
  return fa < fb ? b : a;
}

template <> struct Num<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float max(float a, float b) {
    return float_max(a, b, a, b);
  }
  static __device__ __forceinline__ float lowest() {
    return __uint_as_float(0xFF800000u);
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
};

template <> struct Num<double> {
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double max(double a, double b) {
    return float_max(a, b, a, b);
  }
  static __device__ __forceinline__ double lowest() {
    return __longlong_as_double((long long)0xFFF0000000000000ULL);
  }
  static __device__ __forceinline__ double zero() { return 0.0; }
};

template <> struct Num<__half> {
  static __device__ __forceinline__ __half add(__half a, __half b) {
    return __float2half_rn(__fadd_rn(__half2float(a), __half2float(b)));
  }
  static __device__ __forceinline__ __half max(__half a, __half b) {
    return float_max(a, b, __half2float(a), __half2float(b));
  }
  static __device__ __forceinline__ __half lowest() {
    return __ushort_as_half((unsigned short)0xFC00);
  }
  static __device__ __forceinline__ __half zero() {
    return __ushort_as_half((unsigned short)0);
  }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ __nv_bfloat16 max(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return float_max(a, b, __bfloat162float(a), __bfloat162float(b));
  }
  static __device__ __forceinline__ __nv_bfloat16 lowest() {
    return __ushort_as_bfloat16((unsigned short)0xFF80);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __ushort_as_bfloat16((unsigned short)0);
  }
};

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  return OP == 0 ? Num<T>::add(a, b) : Num<T>::max(a, b);
}

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  return OP == 0 ? Num<T>::zero() : Num<T>::lowest();
}

// Replaces the TPU kernels repro/kernels/block_pack.py:block_acc_shuffle
// (STAGED = false) and block_acc_shuffle_staged (STAGED = true): the reduce
// family's round step, accumulate(t) fused with capture/drain(t+1), in place.
// Per row r, with a = acc[r], f = fwd[r]:
//   c = buf[r, a] op msg[r];  buf[r, a] = c;
//   out[r] = a == f ? c : (STAGED ? pre[r] : the pre-update buf[r, f]);
//   buf[r, f] = identity.
// When a == f the slot ends as the identity and the output is c.
// Ownership: one thread owns element j of row r.  It reads buf[r, a, j],
// msg[r, j] and (when a != f) buf[r, f, j] or pre[r, j] before it writes
// anything, then writes buf[r, a, j] (only when a != f: the drain would
// overwrite it) and buf[r, f, j].  No other thread reads or writes those
// addresses, so no value depends on another thread's write and there is no
// barrier (checked by the audit named at shuffle_kernel).  msg, pre and out
// must not overlap buf or each other.
// Bytes per row: read acc, msg and fwd (or pre), write acc, out and fwd;
// a coincident row reads acc and msg and writes out and fwd:
// (6 * R - 2 * #{a == f}) * row_bytes over 3.35 TB/s.  Two adds or compares
// per element are far below any arithmetic bound, so bytes bound it.  The
// simple design: coalesced typed loads on the same row x chunk grid as the
// copies.  Each thread owns kUnitsPerThread elements of its row (a stride
// apart) and loads all of them before it stores any: the stores of one
// element may alias the loads of the next as far as the compiler knows, so
// one element per step would leave a single 4-byte load per operand in
// flight and the kernel latency-bound.  Rows of 32 units or more; shorter
// rows take acc_shuffle_short_kernel, with the same ownership.
template <typename T, int OP, bool STAGED>
__global__ void __launch_bounds__(kThreads)
acc_shuffle_kernel(T* buf, const T* __restrict__ msg,
                   const T* __restrict__ pre, const int32_t* __restrict__ acc,
                   const int32_t* __restrict__ fwd, T* __restrict__ out,
                   int64_t nslots, int64_t bs) {
  const int64_t r = blockIdx.x;
  const int64_t as = load_slot(acc, r, nslots);
  const int64_t fs = load_slot(fwd, r, nslots);
  const bool same = as == fs;
  T* row = buf + r * nslots * bs;
  T* adst = row + as * bs;
  T* fdst = row + fs * bs;
  const T* m = msg + r * bs;
  const T* pr = STAGED ? pre + r * bs : nullptr;
  T* o = out + r * bs;
  const T ident = identity<T, OP>();
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  for (int64_t j0 = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; j0 < bs;
       j0 += stride * kUnitsPerThread) {
    T a[kUnitsPerThread], v[kUnitsPerThread], f[kUnitsPerThread];
#pragma unroll
    for (int u = 0; u < kUnitsPerThread; ++u) {
      const int64_t j = j0 + u * stride;
      if (j < bs) {
        a[u] = adst[j];
        v[u] = m[j];
        f[u] = same ? a[u] : (STAGED ? pr[j] : fdst[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnitsPerThread; ++u) {
      const int64_t j = j0 + u * stride;
      if (j < bs) {
        const T c = combine<T, OP>(a[u], v[u]);
        if (!same) adst[j] = c;
        fdst[j] = ident;
        o[j] = same ? c : f[u];
      }
    }
  }
}

// The accumulating step at short rows, with acc_shuffle_kernel's semantics,
// on the flat grid of the copy kernels' short rows.  A unit is a Pack of N
// elements of T: 16 bytes (4 f32, 2 f64, 8 f16 or bf16, 16 int8) when the
// row's bytes and every pointer allow it, else N = 1.  combine is applied
// element by element inside the unit, so every result is the one
// acc_shuffle_kernel computes.  Ownership: the thread that owns unit
// (r, j) reads buf[r, a, j], msg[r, j] and (when a != f) buf[r, f, j] or
// pre[r, j] before it writes anything, then writes buf[r, a, j] (only when
// a != f), buf[r, f, j] and out[r, j]; no other thread touches those
// addresses, so there is no barrier.  Rows of one warp may disagree on
// a == f: a branch on a loaded predicate, not a race.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T e[N];
};

template <typename T, int OP, bool STAGED, int N>
__global__ void __launch_bounds__(kThreads)
acc_shuffle_short_kernel(Pack<T, N>* buf, const Pack<T, N>* __restrict__ msg,
                         const Pack<T, N>* __restrict__ pre,
                         const int32_t* __restrict__ acc,
                         const int32_t* __restrict__ fwd,
                         Pack<T, N>* __restrict__ out, int64_t nslots,
                         uint32_t units, uint32_t total) {
  using V = Pack<T, N>;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < total;
       i0 += stride * kShortK) {
    V a[kShortK], v[kShortK], f[kShortK];
    int64_t adst[kShortK], fdst[kShortK];
    bool same[kShortK];
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        const uint32_t r = i / units;
        const int64_t j = i - r * units;
        const int64_t row = (int64_t)r * nslots;
        const int64_t as = load_slot(acc, r, nslots);
        const int64_t fs = load_slot(fwd, r, nslots);
        same[k] = as == fs;
        adst[k] = (row + as) * units + j;
        fdst[k] = (row + fs) * units + j;
        a[k] = buf[adst[k]];
        v[k] = msg[i];
        if (!same[k]) f[k] = STAGED ? pre[i] : buf[fdst[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < kShortK; ++k) {
      const uint32_t i = i0 + k * stride;
      if (i < total) {
        V c, z;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          c.e[e] = combine<T, OP>(a[k].e[e], v[k].e[e]);
          z.e[e] = identity<T, OP>();
        }
        if (!same[k]) buf[adst[k]] = c;
        buf[fdst[k]] = z;
        out[i] = same[k] ? c : f[k];
      }
    }
  }
}

// ------------------------------------------- the quantized reduce's step
//
// Replaces the TPU kernel repro/kernels/block_pack.py:block_qacc_shuffle
// (body _qacc_shuffle_kernel): the int8-wire reduce round step, sum only,
// in place.  buf and err are [R, nslots, bs] float, qmsg [R, bs] int8,
// smsg [R, nb] float (bs = nb * qb), outq [R, bs] int8, outs [R, nb]
// float.  Per row r, with a = acc[r], f = fwd[r], and per quantization
// block of qb elements:
//   c = fma(q, s, buf[r, a]);  buf[r, a] = c;
//   x = a == f ? c : the pre-update buf[r, f]      (the capture);
//   scale = max(amax_finite(x) * INV127, 1e-12);
//   outq = clip(rint(x_finite / scale), +-127);   outs = scale, or NaN
//   when the block holds a non-finite x;
//   err[r, f] += fma(-outq, scale, x), 0 where that is not finite
//   (and everywhere in a NaN-scale block);
//   buf[r, f] = 0.
// The arithmetic is the jitted reference's, which XLA contracts into
// fused multiply-adds (the accumulate and the error capture, one rounding
// each), so it is written with intrinsics and no contraction choice of
// nvcc can change it: __fmaf_rn, __fmul_rn, __fdiv_rn (a true division),
// rintf (round half to even), __fadd_rn.  The library is built without
// --use_fast_math and -ftz.
// Layout: one warp owns one (row, quantization block).  The TPU kernel's
// two-step grid (accumulate at step 0, drain at step 1, the block staged
// in VMEM) becomes: each lane loads its elements of buf[a], buf[f],
// err[f] and qmsg before any store, the warp reduces amax with
// __shfl_xor_sync (max is exact, so order does not matter) and the
// non-finite flag with __any_sync, then each lane stores.  No element is
// read after another lane's write, so there is no barrier.  A lane holds
// up to K units of V floats in registers; a block longer than 32 * K
// units is read twice (amax pass, then store pass), and each element is
// read and written by the same lane in both.  V = 4 (16-byte loads of
// buf/err, 4-byte loads of int8) where qb and the pointers allow, else 1.
// What bounds it: bytes.  A row whose slots differ reads buf[a], buf[f],
// err[f], qmsg, smsg and writes buf[a], buf[f], err[f], outq, outs:
// 6 float rows, 2 int8 rows and 2 scale rows; a coincident row moves
// 4 float rows and the same int8 and scale rows.  A few flops per
// element are far below the arithmetic bound.
constexpr float kInv127 = 0x1.020408p-7f;   // float(1) / float(127)
constexpr float kScaleFloor = 0x1.197998p-40f;   // float(1e-12)

template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&d)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* p, const float (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
  } else {
    *p = d[0];
  }
}

template <int V>
__device__ __forceinline__ void load_q(const int8_t* p, int8_t (&d)[V]) {
  if constexpr (V == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const int8_t (&d)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(p) = make_char4(d[0], d[1], d[2], d[3]);
  } else {
    *p = d[0];
  }
}

// One chunk of a lane's elements (units c0 + k*32 + lane), all loaded
// before any store of that chunk: c = the accumulated value fma(q, s, a),
// x = the capture, e = the old error.
template <int V, int K>
__device__ __forceinline__ void qacc_load(
    int64_t c0, int lane, int64_t units, bool same, float s_in,
    const float* ap, const float* fp, const float* ep, const int8_t* qp,
    float (&c)[K][V], float (&x)[K][V], float (&e)[K][V]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t u = c0 + k * 32 + lane;
    if (u < units) {
      float a[V], f[V];
      int8_t q[V];
      load_f<V>(ap + u * V, a);
      load_q<V>(qp + u * V, q);
      if (!same) load_f<V>(fp + u * V, f);
      load_f<V>(ep + u * V, e[k]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        c[k][v] = __fmaf_rn((float)q[v], s_in, a[v]);
        x[k][v] = same ? c[k][v] : f[v];
      }
    }
  }
}

template <int V, int K>
__global__ void __launch_bounds__(kThreads)
qacc_shuffle_kernel(float* buf, float* err, const int8_t* __restrict__ qmsg,
                    const float* __restrict__ smsg,
                    const int32_t* __restrict__ acc,
                    const int32_t* __restrict__ fwd,
                    int8_t* __restrict__ outq, float* __restrict__ outs,
                    int64_t R, int64_t nslots, int64_t bs, int64_t qb) {
  const int64_t nb = bs / qb;
  const int64_t w = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (w >= R * nb) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int64_t r = w / nb;
  const int64_t off = (w - r * nb) * qb;
  const int64_t as = load_slot(acc, r, nslots);
  const int64_t fs = load_slot(fwd, r, nslots);
  const bool same = as == fs;
  float* ap = buf + (r * nslots + as) * bs + off;
  float* fp = buf + (r * nslots + fs) * bs + off;
  float* ep = err + (r * nslots + fs) * bs + off;
  const int8_t* qp = qmsg + r * bs + off;
  int8_t* op = outq + r * bs + off;
  const float s_in = smsg[w];
  const int64_t units = qb / V;
  const bool held = units <= 32 * K;  // one chunk holds the whole block

  float c[K][V], x[K][V], e[K][V];
  float amax = 0.0f;
  bool bad = false;
  for (int64_t c0 = 0; c0 < units; c0 += 32 * K) {
    qacc_load<V, K>(c0, lane, units, same, s_in, ap, fp, ep, qp, c, x, e);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (c0 + k * 32 + lane < units) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          if (isfinite(x[k][v])) amax = fmaxf(amax, fabsf(x[k][v]));
          else bad = true;
        }
      }
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  bad = __any_sync(0xffffffffu, bad);
  const float scale = fmaxf(__fmul_rn(amax, kInv127), kScaleFloor);
  if (lane == 0) outs[w] = bad ? __uint_as_float(0x7fc00000u) : scale;

  for (int64_t c0 = 0; c0 < units; c0 += 32 * K) {
    if (!held)
      qacc_load<V, K>(c0, lane, units, same, s_in, ap, fp, ep, qp, c, x, e);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t u = c0 + k * 32 + lane;
      if (u < units) {
        int8_t q[V];
        float ne[V], zero[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xv = x[k][v];
          const float xf = isfinite(xv) ? xv : 0.0f;
          q[v] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(xf, scale)), -127.0f),
                               127.0f);
          // -(float)q, not -rint(...): a rint of -0 must still subtract +0.
          const float eps = bad ? 0.0f : __fmaf_rn(-(float)q[v], scale, xv);
          ne[v] = __fadd_rn(e[k][v], isfinite(eps) ? eps : 0.0f);
          zero[v] = 0.0f;
        }
        if (!same) store_f<V>(ap + u * V, c[k]);
        store_f<V>(fp + u * V, zero);
        store_f<V>(ep + u * V, ne);
        store_q<V>(op + u * V, q);
      }
    }
  }
}

template <int V, int K>
int qacc_typed(const LaunchShape& sh, void* buf, void* err, const void* qmsg,
               const void* smsg, const void* acc, const void* fwd, void* outq,
               void* outs, int64_t R, int64_t nslots, int64_t bs, int64_t qb,
               cudaStream_t stream) {
  return launch_grid(sh, [&](dim3 grid) {
    qacc_shuffle_kernel<V, K><<<grid, (unsigned)sh.block, 0, stream>>>(
        static_cast<float*>(buf), static_cast<float*>(err),
        static_cast<const int8_t*>(qmsg), static_cast<const float*>(smsg),
        static_cast<const int32_t*>(acc), static_cast<const int32_t*>(fwd),
        static_cast<int8_t*>(outq), static_cast<float*>(outs), R, nslots, bs,
        qb);
  });
}

// K (sh.steps) is the least of 1, 2, 4, 8 whose 32 * K units hold a block
// (8 beyond).
template <int V>
int qacc_dispatch(const LaunchShape& sh, void* buf, void* err,
                  const void* qmsg, const void* smsg, const void* acc,
                  const void* fwd, void* outq, void* outs, int64_t R,
                  int64_t nslots, int64_t bs, int64_t qb, cudaStream_t s) {
  switch (sh.steps) {
    case 1: return qacc_typed<V, 1>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
    case 2: return qacc_typed<V, 2>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
    case 4: return qacc_typed<V, 4>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
    default: return qacc_typed<V, 8>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
  }
}

template <typename V>
int pack_typed(const LaunchShape& sh, const void* buf, const void* idx,
               void* out, int64_t R, int64_t nslots, cudaStream_t stream) {
  const int64_t units = sh.units;
  const V* b = static_cast<const V*>(buf);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  V* o = static_cast<V*>(out);
  if (sh.route == kShortRows) {
    static std::atomic<int> per_sm{0};
    return by_slabs(pack_short_kernel<V>, per_sm, sh, R,
                    [&](int64_t r0, uint32_t total, unsigned grid) {
      pack_short_kernel<V><<<grid, kThreads, 0, stream>>>(
          b + r0 * nslots * units, ix + r0, o + r0 * units, nslots,
          (uint32_t)units, total);
    });
  }
  return launch_grid(sh, [&](dim3 grid) {
    pack_kernel<V><<<grid, (unsigned)sh.block, 0, stream>>>(
        b, ix, o, nslots, units);
  });
}

template <typename V>
int unpack_typed(const LaunchShape& sh, void* buf, const void* msg,
                 const void* idx, int64_t R, int64_t nslots,
                 cudaStream_t stream) {
  const int64_t units = sh.units;
  V* b = static_cast<V*>(buf);
  const V* m = static_cast<const V*>(msg);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  if (sh.route == kShortRows) {
    static std::atomic<int> per_sm{0};
    return by_slabs(unpack_short_kernel<V>, per_sm, sh, R,
                    [&](int64_t r0, uint32_t total, unsigned grid) {
      unpack_short_kernel<V><<<grid, kThreads, 0, stream>>>(
          b + r0 * nslots * units, m + r0 * units, ix + r0, nslots,
          (uint32_t)units, total);
    });
  }
  return launch_grid(sh, [&](dim3 grid) {
    unpack_kernel<V><<<grid, (unsigned)sh.block, 0, stream>>>(
        b, m, ix, nslots, units);
  });
}

template <typename V>
int shuffle_typed(const LaunchShape& sh, void* buf, const void* msg,
                  const void* recv, const void* send, void* out, int64_t R,
                  int64_t nslots, cudaStream_t stream) {
  const int64_t units = sh.units;
  V* b = static_cast<V*>(buf);
  const V* m = static_cast<const V*>(msg);
  const int32_t* rv = static_cast<const int32_t*>(recv);
  const int32_t* sd = static_cast<const int32_t*>(send);
  V* o = static_cast<V*>(out);
  if (sh.route == kShortRows) {
    static std::atomic<int> per_sm{0};
    return by_slabs(shuffle_short_kernel<V>, per_sm, sh, R,
                    [&](int64_t r0, uint32_t total, unsigned grid) {
      shuffle_short_kernel<V><<<grid, kThreads, 0, stream>>>(
          b + r0 * nslots * units, m + r0 * units, rv + r0, sd + r0,
          o + r0 * units, nslots, (uint32_t)units, total);
    });
  }
  return launch_grid(sh, [&](dim3 grid) {
    shuffle_kernel<V><<<grid, (unsigned)sh.block, 0, stream>>>(
        b, m, rv, sd, o, nslots, units);
  });
}

template <typename V>
int shuffle_staged_typed(const LaunchShape& sh, void* buf, const void* msg,
                         const void* pre, const void* recv, const void* send,
                         void* out, int64_t R, int64_t nslots,
                         cudaStream_t stream) {
  const int64_t units = sh.units;
  V* b = static_cast<V*>(buf);
  const V* m = static_cast<const V*>(msg);
  const V* pr = static_cast<const V*>(pre);
  const int32_t* rv = static_cast<const int32_t*>(recv);
  const int32_t* sd = static_cast<const int32_t*>(send);
  V* o = static_cast<V*>(out);
  if (sh.route == kShortRows) {
    static std::atomic<int> per_sm{0};
    return by_slabs(shuffle_staged_short_kernel<V>, per_sm, sh, R,
                    [&](int64_t r0, uint32_t total, unsigned grid) {
      shuffle_staged_short_kernel<V><<<grid, kThreads, 0, stream>>>(
          b + r0 * nslots * units, m + r0 * units, pr + r0 * units, rv + r0,
          sd + r0, o + r0 * units, nslots, (uint32_t)units, total);
    });
  }
  return launch_grid(sh, [&](dim3 grid) {
    shuffle_staged_kernel<V><<<grid, (unsigned)sh.block, 0, stream>>>(
        b, m, pr, rv, sd, o, nslots, units);
  });
}

// The short-row accumulating step in units of N elements: rows r0 on of
// each slab start at r0 * nslots * units units into buf, r0 * units into
// msg, pre and out.
template <typename T, int OP, bool STAGED, int N>
int acc_short(const LaunchShape& sh, void* buf, const void* msg,
              const void* pre, const int32_t* a, const int32_t* f, void* out,
              int64_t R, int64_t nslots, cudaStream_t stream) {
  using V = Pack<T, N>;
  const int64_t units = sh.units;
  V* b = static_cast<V*>(buf);
  const V* m = static_cast<const V*>(msg);
  const V* p = static_cast<const V*>(pre);
  V* o = static_cast<V*>(out);
  static std::atomic<int> per_sm{0};
  return by_slabs(acc_shuffle_short_kernel<T, OP, STAGED, N>, per_sm, sh, R,
                  [&](int64_t r0, uint32_t total, unsigned grid) {
    acc_shuffle_short_kernel<T, OP, STAGED, N><<<grid, kThreads, 0, stream>>>(
        b + r0 * nslots * units, m + r0 * units, STAGED ? p + r0 * units : p,
        a + r0, f + r0, o + r0 * units, nslots, (uint32_t)units, total);
  });
}

template <typename T, bool STAGED>
int acc_typed(void* buf, const void* msg, const void* pre, const void* acc,
              const void* fwd, void* out, int op, int64_t R, int64_t nslots,
              int64_t row_bytes, cudaStream_t stream) {
  const int32_t* a = static_cast<const int32_t*>(acc);
  const int32_t* f = static_cast<const int32_t*>(fwd);
  constexpr int N = 16 / (int)sizeof(T);
  const uintptr_t ptrs =
      (uintptr_t)buf | (uintptr_t)msg | (uintptr_t)pre | (uintptr_t)out;
  const LaunchShape sh =
      launch_shape(STAGED ? kAccShuffleStaged : kAccShuffle, R, row_bytes, 0,
                   (int64_t)sizeof(T), ptrs, 0, 0);
  if (sh.route == kShortRows) {
    if (sh.unit != (int64_t)sizeof(T))  // packs of N elements
      return op == 0
          ? acc_short<T, 0, STAGED, N>(sh, buf, msg, pre, a, f, out, R, nslots, stream)
          : acc_short<T, 1, STAGED, N>(sh, buf, msg, pre, a, f, out, R, nslots, stream);
    return op == 0
        ? acc_short<T, 0, STAGED, 1>(sh, buf, msg, pre, a, f, out, R, nslots, stream)
        : acc_short<T, 1, STAGED, 1>(sh, buf, msg, pre, a, f, out, R, nslots, stream);
  }
  const int64_t bs = sh.units;
  T* b = static_cast<T*>(buf);
  const T* m = static_cast<const T*>(msg);
  const T* p = static_cast<const T*>(pre);
  T* o = static_cast<T*>(out);
  return launch_grid(sh, [&](dim3 grid) {
    if (op == 0)
      acc_shuffle_kernel<T, 0, STAGED><<<grid, (unsigned)sh.block, 0, stream>>>(
          b, m, p, a, f, o, nslots, bs);
    else
      acc_shuffle_kernel<T, 1, STAGED><<<grid, (unsigned)sh.block, 0, stream>>>(
          b, m, p, a, f, o, nslots, bs);
  });
}

// dtype codes as in kernels/block_pack.py ACC_DTYPES.
template <bool STAGED>
int acc_launch(void* buf, const void* msg, const void* pre, const void* acc,
               const void* fwd, void* out, int dtype, int op, int64_t R,
               int64_t nslots, int64_t row_bytes, int device, void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (op != 0 && op != 1) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return acc_typed<float, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 1: return acc_typed<double, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 2: return acc_typed<__half, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 3: return acc_typed<__nv_bfloat16, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 4: return acc_typed<int8_t, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 5: return acc_typed<int16_t, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 6: return acc_typed<int32_t, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    case 7: return acc_typed<int64_t, STAGED>(buf, msg, pre, acc, fwd, out, op, R, nslots, row_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int block_pack_launch(const void* buf, const void* idx, void* out, int64_t R,
                      int64_t nslots, int64_t row_bytes, int device,
                      void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LaunchShape sh = launch_shape(
      kPack, R, row_bytes, 0, 1, (uintptr_t)buf | (uintptr_t)out, 0, 0);
  switch (sh.unit) {
    case 16: return pack_typed<uint4>(sh, buf, idx, out, R, nslots, s);
    case 8: return pack_typed<uint2>(sh, buf, idx, out, R, nslots, s);
    case 4: return pack_typed<uint32_t>(sh, buf, idx, out, R, nslots, s);
    case 2: return pack_typed<uint16_t>(sh, buf, idx, out, R, nslots, s);
    default: return pack_typed<uint8_t>(sh, buf, idx, out, R, nslots, s);
  }
}

int block_unpack_launch(void* buf, const void* msg, const void* idx, int64_t R,
                        int64_t nslots, int64_t row_bytes, int device,
                        void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LaunchShape sh = launch_shape(
      kUnpack, R, row_bytes, 0, 1, (uintptr_t)buf | (uintptr_t)msg, 0, 0);
  switch (sh.unit) {
    case 16: return unpack_typed<uint4>(sh, buf, msg, idx, R, nslots, s);
    case 8: return unpack_typed<uint2>(sh, buf, msg, idx, R, nslots, s);
    case 4: return unpack_typed<uint32_t>(sh, buf, msg, idx, R, nslots, s);
    case 2: return unpack_typed<uint16_t>(sh, buf, msg, idx, R, nslots, s);
    default: return unpack_typed<uint8_t>(sh, buf, msg, idx, R, nslots, s);
  }
}

int block_shuffle_launch(void* buf, const void* msg, const void* recv,
                         const void* send, void* out, int64_t R,
                         int64_t nslots, int64_t row_bytes, int device,
                         void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs = (uintptr_t)buf | (uintptr_t)msg | (uintptr_t)out;
  const LaunchShape sh = launch_shape(kShuffle, R, row_bytes, 0, 1, ptrs, 0, 0);
  switch (sh.unit) {
    case 16: return shuffle_typed<uint4>(sh, buf, msg, recv, send, out, R, nslots, s);
    case 8: return shuffle_typed<uint2>(sh, buf, msg, recv, send, out, R, nslots, s);
    case 4: return shuffle_typed<uint32_t>(sh, buf, msg, recv, send, out, R, nslots, s);
    case 2: return shuffle_typed<uint16_t>(sh, buf, msg, recv, send, out, R, nslots, s);
    default: return shuffle_typed<uint8_t>(sh, buf, msg, recv, send, out, R, nslots, s);
  }
}

int block_shuffle_staged_launch(void* buf, const void* msg, const void* pre,
                                const void* recv, const void* send, void* out,
                                int64_t R, int64_t nslots, int64_t row_bytes,
                                int device, void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t ptrs =
      (uintptr_t)buf | (uintptr_t)msg | (uintptr_t)pre | (uintptr_t)out;
  const LaunchShape sh =
      launch_shape(kShuffleStaged, R, row_bytes, 0, 1, ptrs, 0, 0);
  switch (sh.unit) {
    case 16: return shuffle_staged_typed<uint4>(sh, buf, msg, pre, recv, send, out, R, nslots, s);
    case 8: return shuffle_staged_typed<uint2>(sh, buf, msg, pre, recv, send, out, R, nslots, s);
    case 4: return shuffle_staged_typed<uint32_t>(sh, buf, msg, pre, recv, send, out, R, nslots, s);
    case 2: return shuffle_staged_typed<uint16_t>(sh, buf, msg, pre, recv, send, out, R, nslots, s);
    default: return shuffle_staged_typed<uint8_t>(sh, buf, msg, pre, recv, send, out, R, nslots, s);
  }
}

int block_acc_shuffle_launch(void* buf, const void* msg, const void* acc,
                             const void* fwd, void* out, int dtype, int op,
                             int64_t R, int64_t nslots, int64_t row_bytes,
                             int device, void* stream) {
  return acc_launch<false>(buf, msg, nullptr, acc, fwd, out, dtype, op, R,
                           nslots, row_bytes, device, stream);
}

int block_acc_shuffle_staged_launch(void* buf, const void* msg,
                                    const void* pre, const void* acc,
                                    const void* fwd, void* out, int dtype,
                                    int op, int64_t R, int64_t nslots,
                                    int64_t row_bytes, int device,
                                    void* stream) {
  return acc_launch<true>(buf, msg, pre, acc, fwd, out, dtype, op, R, nslots,
                          row_bytes, device, stream);
}

int block_qacc_shuffle_launch(void* buf, void* err, const void* qmsg,
                              const void* smsg, const void* acc,
                              const void* fwd, void* outq, void* outs,
                              int64_t R, int64_t nslots, int64_t bs,
                              int64_t qb, int device, void* stream) {
  if (R <= 0 || bs <= 0) return 0;
  if (qb <= 0 || bs % qb != 0) return (int)cudaErrorInvalidValue;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LaunchShape sh = launch_shape(
      kQaccShuffle, R, bs, qb, 4, (uintptr_t)buf | (uintptr_t)err,
      (uintptr_t)qmsg | (uintptr_t)outq, 0);
  if (sh.grid_x > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  if (sh.unit == 16)
    return qacc_dispatch<4>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
  return qacc_dispatch<1>(sh, buf, err, qmsg, smsg, acc, fwd, outq, outs, R, nslots, bs, qb, s);
}

// The launch shape the entry point of `kernel` (enum Kernel) would take for
// these operands, written as kShapeFields int64 to `shape` in LaunchShape's
// order; nothing is launched.  The operands are those of that entry point
// (nullptr where it has none; size and qb as it takes them); their
// addresses choose the unit and are not read.
int block_pack_launch_shape(int kernel, void* buf, void* msg, void* pre,
                            void* out, void* err, void* outq, void* outs,
                            int dtype, int op, int64_t R, int64_t nslots,
                            int64_t size, int64_t qb, int device,
                            int64_t* shape) {
  LaunchShape sh{};
  t_dry = &sh;
  int rc;
  switch (kernel) {
    case kPack:
      rc = block_pack_launch(buf, nullptr, out, R, nslots, size, device, nullptr);
      break;
    case kUnpack:
      rc = block_unpack_launch(buf, msg, nullptr, R, nslots, size, device, nullptr);
      break;
    case kShuffle:
      rc = block_shuffle_launch(buf, msg, nullptr, nullptr, out, R, nslots,
                                size, device, nullptr);
      break;
    case kShuffleStaged:
      rc = block_shuffle_staged_launch(buf, msg, pre, nullptr, nullptr, out,
                                       R, nslots, size, device, nullptr);
      break;
    case kAccShuffle:
      rc = block_acc_shuffle_launch(buf, msg, nullptr, nullptr, out, dtype,
                                    op, R, nslots, size, device, nullptr);
      break;
    case kAccShuffleStaged:
      rc = block_acc_shuffle_staged_launch(buf, msg, pre, nullptr, nullptr,
                                           out, dtype, op, R, nslots, size,
                                           device, nullptr);
      break;
    case kQaccShuffle:
      rc = block_qacc_shuffle_launch(buf, err, msg, nullptr, nullptr, nullptr,
                                     outq, outs, R, nslots, size, qb, device,
                                     nullptr);
      break;
    default:
      rc = (int)cudaErrorInvalidValue;
  }
  t_dry = nullptr;
  const int64_t fields[kShapeFields] = {sh.route, sh.unit, sh.units,
                                        sh.grid_x, sh.grid_y, sh.block,
                                        sh.steps, sh.launches, sh.resident};
  for (int i = 0; i < kShapeFields; ++i) shape[i] = fields[i];
  return rc;
}

const char* block_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
