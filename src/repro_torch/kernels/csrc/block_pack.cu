// Round-step kernels of the n-block circulant broadcast, for Hopper (sm_90a).
//
// Buffers are [R, nslots, bs] row-major tensors (one row per rank), messages
// [R, bs], slot vectors [R] int32.  The kernels only move data, so they are
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
//
// What bounds them on an H100: bytes.  They do no arithmetic, so the least
// time is the bytes they must move over the 3.35 TB/s of device memory:
// pack and unpack read one block and write one block per row
// (2 * R * row_bytes), shuffle reads two and writes two (4 * R * row_bytes).
// The simple design answers that with wide, coalesced, aligned accesses and
// enough thread blocks (R x chunks) to keep every SM's loads in flight; it
// does not stage through shared memory, since each byte is touched once.
// TMA bulk copies and warp specialisation are later work.
//
// C interface (bound with ctypes): each entry point makes the given device
// current, launches on the given stream (the caller's PyTorch stream), does
// not synchronise, and returns cudaGetLastError() (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;  // each thread block covers 256 * 4 units
constexpr int64_t kMaxChunks = 65535;  // gridDim.y limit

__device__ __forceinline__ int64_t load_slot(const int32_t* idx, int64_t r,
                                             int64_t nslots) {
  const int64_t s = idx[r];
  if (s < 0 || s >= nslots) __trap();
  return s;
}

// Replaces the TPU kernel repro/kernels/block_pack.py:block_pack (gather):
// out[r] = buf[r, idx[r]].
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
// msg and out must not overlap buf or each other.
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

template <typename V>
int pack_typed(const void* buf, const void* idx, void* out, int64_t R,
               int64_t nslots, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(V);
  pack_kernel<V><<<grid_for(R, units), kThreads, 0, stream>>>(
      static_cast<const V*>(buf), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), nslots, units);
  return (int)cudaGetLastError();
}

template <typename V>
int unpack_typed(void* buf, const void* msg, const void* idx, int64_t R,
                 int64_t nslots, int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(V);
  unpack_kernel<V><<<grid_for(R, units), kThreads, 0, stream>>>(
      static_cast<V*>(buf), static_cast<const V*>(msg),
      static_cast<const int32_t*>(idx), nslots, units);
  return (int)cudaGetLastError();
}

template <typename V>
int shuffle_typed(void* buf, const void* msg, const void* recv,
                  const void* send, void* out, int64_t R, int64_t nslots,
                  int64_t row_bytes, cudaStream_t stream) {
  const int64_t units = row_bytes / (int64_t)sizeof(V);
  shuffle_kernel<V><<<grid_for(R, units), kThreads, 0, stream>>>(
      static_cast<V*>(buf), static_cast<const V*>(msg),
      static_cast<const int32_t*>(recv), static_cast<const int32_t*>(send),
      static_cast<V*>(out), nslots, units);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int block_pack_launch(const void* buf, const void* idx, void* out, int64_t R,
                      int64_t nslots, int64_t row_bytes, int device,
                      void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes(row_bytes, (uintptr_t)buf | (uintptr_t)out)) {
    case 16: return pack_typed<uint4>(buf, idx, out, R, nslots, row_bytes, s);
    case 8: return pack_typed<uint2>(buf, idx, out, R, nslots, row_bytes, s);
    case 4: return pack_typed<uint32_t>(buf, idx, out, R, nslots, row_bytes, s);
    case 2: return pack_typed<uint16_t>(buf, idx, out, R, nslots, row_bytes, s);
    default: return pack_typed<uint8_t>(buf, idx, out, R, nslots, row_bytes, s);
  }
}

int block_unpack_launch(void* buf, const void* msg, const void* idx, int64_t R,
                        int64_t nslots, int64_t row_bytes, int device,
                        void* stream) {
  if (R <= 0 || row_bytes <= 0) return 0;
  if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes(row_bytes, (uintptr_t)buf | (uintptr_t)msg)) {
    case 16: return unpack_typed<uint4>(buf, msg, idx, R, nslots, row_bytes, s);
    case 8: return unpack_typed<uint2>(buf, msg, idx, R, nslots, row_bytes, s);
    case 4: return unpack_typed<uint32_t>(buf, msg, idx, R, nslots, row_bytes, s);
    case 2: return unpack_typed<uint16_t>(buf, msg, idx, R, nslots, row_bytes, s);
    default: return unpack_typed<uint8_t>(buf, msg, idx, R, nslots, row_bytes, s);
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
  switch (unit_bytes(row_bytes, ptrs)) {
    case 16:
      return shuffle_typed<uint4>(buf, msg, recv, send, out, R, nslots, row_bytes, s);
    case 8:
      return shuffle_typed<uint2>(buf, msg, recv, send, out, R, nslots, row_bytes, s);
    case 4:
      return shuffle_typed<uint32_t>(buf, msg, recv, send, out, R, nslots, row_bytes, s);
    case 2:
      return shuffle_typed<uint16_t>(buf, msg, recv, send, out, R, nslots, row_bytes, s);
    default:
      return shuffle_typed<uint8_t>(buf, msg, recv, send, out, R, nslots, row_bytes, s);
  }
}

const char* block_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
