// The stacked exchange's row rotation, for Hopper (sm_90a).
//
// A contiguous tensor is viewed as bytes [outer, A, inner]; the kernel writes
// out[o, (a + s) mod A] = in[o, a].  It replaces torch.roll along dim 0 or 1
// of that view in the port's exchange (core/comm.py _roll, core/hier.py's
// level rolls); it ports no TPU kernel: on the TPU the exchange was a
// collective permute between chips, and on one card it is this copy.
//
// Each outer index is a row of L = A * inner bytes rotated by split = s *
// inner bytes: out_row[(w + split) mod L] = in_row[w].  That is two contiguous
// segments, in_row[0, L - split) -> out_row[split, L) and in_row[L - split, L)
// -> out_row[0, split), so a thread finds its destination with one compare
// and one subtraction: no division per element, as torch.roll's element-wise
// gather does.
//
// What bounds it on an H100: bytes.  It reads every byte once and writes it
// once (2 * outer * L bytes over the 3.35 TB/s of device memory).  The design
// answers that with wide, coalesced accesses and many loads in flight:
//   * units of U bytes, the widest of 16, 8, 4, 2, 1 that divides inner and
//     both base pointers (the wrapper's choice, checked here): then L, split
//     and every row start are multiples of U, so every access is aligned.
//     16-byte units give one 128-bit load and store a thread a step;
//   * each thread loads kUnroll units (kThreads units apart, so a warp's
//     loads are contiguous) before it stores any, so kUnroll independent
//     loads are in flight a thread;
//   * streaming cache hints (ld.global.cs / st.global.cs): every byte is
//     touched exactly once;
//   * one block a tile of kThreads * kUnroll units, each tile inside one row
//     (the row's last tile is partial); past the grid's 2^31 - 1 blocks the
//     blocks walk the tiles grid-stride.  On an H100 (700 W) a persistent
//     grid of 8 blocks an SM (a multiple of the 132 SMs, walking the tiles)
//     reached 77-84 % of the HBM roofline at the benchmark's messages (333
//     to 522 MB), one block a tile 87-88 %, as many short-lived blocks keep
//     more loads in flight.
//
// C interface (bound with ctypes): row_roll_launch makes the given device
// current (where it is not), launches on the given stream (the caller's
// PyTorch stream), does not synchronise, and returns cudaGetLastError()
// (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kTile = (int64_t)kThreads * kUnroll;
constexpr int64_t kMaxBlocks = 0x7fffffff;  // gridDim.x

template <typename V>
__global__ void __launch_bounds__(kThreads)
roll_rows_kernel(const V* __restrict__ in, V* __restrict__ out, int64_t outer,
                 int64_t row, int64_t split, int64_t row_tiles) {
  const int64_t tiles = outer * row_tiles;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t o = t / row_tiles;
    const int64_t w0 = (t - o * row_tiles) * kTile + threadIdx.x;
    const V* src = in + o * row;
    V* dst = out + o * row;
    V v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t w = w0 + (int64_t)k * kThreads;
      if (w < row) v[k] = __ldcs(src + w);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t w = w0 + (int64_t)k * kThreads;
      if (w < row) {
        const int64_t d = w + split;
        __stcs(dst + (d < row ? d : d - row), v[k]);
      }
    }
  }
}

template <typename V>
int launch_typed(const void* in, void* out, int64_t outer, int64_t row_bytes,
                 int64_t split_bytes, cudaStream_t s) {
  const int64_t row = row_bytes / (int64_t)sizeof(V);
  const int64_t row_tiles = (row + kTile - 1) / kTile;
  const int64_t tiles = outer * row_tiles;
  const int64_t blocks = tiles < kMaxBlocks ? tiles : kMaxBlocks;
  roll_rows_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const V*>(in), static_cast<V*>(out), outer, row,
      split_bytes / (int64_t)sizeof(V), row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: [outer, row_bytes] contiguous bytes; split_bytes in [0, row_bytes);
// unit: 16, 8, 4, 2 or 1, dividing row_bytes, split_bytes and both pointers.
int row_roll_launch(const void* in, void* out, int64_t outer,
                    int64_t row_bytes, int64_t split_bytes, int unit,
                    int device, void* stream) {
  if (outer <= 0 || row_bytes <= 0) return 0;
  if (unit != 16 && unit != 8 && unit != 4 && unit != 2 && unit != 1)
    return (int)cudaErrorInvalidValue;
  if (split_bytes < 0 || split_bytes >= row_bytes || row_bytes % unit ||
      split_bytes % unit || ((uintptr_t)in | (uintptr_t)out) % unit)
    return (int)cudaErrorInvalidValue;
  // switch devices only where the caller's differs, as PyTorch's device
  // guard does: this launch is on the host's path once a message a round
  int current;
  if (cudaError_t e = cudaGetDevice(&current)) return (int)e;
  if (current != device)
    if (cudaError_t e = cudaSetDevice(device)) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch_typed<uint4>(in, out, outer, row_bytes, split_bytes, s);
    case 8: return launch_typed<uint2>(in, out, outer, row_bytes, split_bytes, s);
    case 4: return launch_typed<unsigned int>(in, out, outer, row_bytes, split_bytes, s);
    case 2: return launch_typed<unsigned short>(in, out, outer, row_bytes, split_bytes, s);
    default: return launch_typed<unsigned char>(in, out, outer, row_bytes, split_bytes, s);
  }
}

const char* row_roll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
