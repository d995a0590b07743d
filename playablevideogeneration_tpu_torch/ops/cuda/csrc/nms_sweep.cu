// Greedy NMS sweep over score-sorted candidate sets.
//
// Replaces no Pallas kernel: it is the counterpart of the lax.scan in the
// JAX package's nms_mask
// (playablevideogeneration_tpu/evaluation/metrics/frcnn.py:277-301), which
// XLA compiles into the detector's device program.  For each of S sets of
// n candidates, already sorted by score, the caller gives the rows of the
// sorted IoU > threshold matrix packed to bits: row i holds `words` 32-bit
// words, column j in bit j % 32 of word j / 32.  Candidate i is kept
// unless a kept candidate before it overlaps it (bit i of a kept row j < i);
// the output is the (S, n) keep mask in score order, one byte per
// candidate.  The result is boolean, so the kernel equals its plain
// version (ops/cuda/nms_sweep.py) bit for bit.
//
// Bound on an H100: the sweep is a chain of n dependent steps per set, and
// its bytes are few (each row read once, at most 128 bytes for n <= 1024;
// about 8 MB for the 64 sets of 1000 candidates of a 16-frame RPN call,
// 2.5 us at 3.35 TB/s).  So the chain sets the time, and the design keeps
// each step in registers:
//   - one warp per set; lane l owns bits 32l .. 32l + 31 of the suppressed
//     mask (n <= 1024 = 32 lanes x 32 bits);
//   - the candidates go in chunks of 32.  Before a chunk each lane loads
//     its word of the chunk's 32 rows and the chunk owner's word of each
//     row (the diagonal block, one broadcast load per row): all 64 loads
//     are independent, so they are in flight together;
//   - within the chunk every lane holds the owner's word, so a step is a
//     shift, a test and two ORs in registers, with no shuffle and no load;
//     one shuffle per chunk brings the owner's word in;
//   - after the chunk lane t writes candidate 32c + t's byte.
// Prefetching the next chunk's rows during a chunk, or several sets per
// warp, are left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;   // sets per block
constexpr int kMaxWords = 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
    nms_sweep_kernel(const uint32_t* __restrict__ rows, uint8_t* __restrict__ keep, int sets,
                     int n, int words) {
  const int lane = threadIdx.x & 31;
  const int set = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (set >= sets) return;  // a whole warp leaves together
  const uint32_t* base = rows + static_cast<int64_t>(set) * n * words;
  uint8_t* out = keep + static_cast<int64_t>(set) * n;
  uint32_t suppressed = 0;  // bits 32 * lane .. 32 * lane + 31
  for (int chunk = 0; chunk * 32 < n; ++chunk) {
    const int first = chunk * 32;
    const int count = min(32, n - first);
    uint32_t row[32], owner[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const bool in = t < count;
      const uint32_t* r = base + static_cast<int64_t>(first + t) * words;
      row[t] = in && lane < words ? __ldg(r + lane) : 0u;
      owner[t] = in ? __ldg(r + chunk) : 0u;
    }
    uint32_t w = __shfl_sync(kFull, suppressed, chunk);
    uint32_t kept = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      // Candidates past n were given zero rows and are not written.
      if (!((w >> t) & 1u)) {
        kept |= 1u << t;
        w |= owner[t];
        suppressed |= row[t];
      }
    }
    if (lane < count) out[first + lane] = static_cast<uint8_t>((kept >> lane) & 1u);
  }
}

}  // namespace

extern "C" {

// rows: (sets, n, words) uint32 words, 4-byte aligned; keep: (sets, n)
// bytes.  Returns cudaGetLastError() after the launch.
int nms_sweep(const void* rows, void* keep, int64_t sets, int64_t n, int64_t words, int device,
              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sets == 0 || n == 0) return 0;
  if (n > kMaxWords * 32 || words < (n + 31) / 32 || words > kMaxWords ||
      sets >= (int64_t{1} << 31) - kWarps ||
      reinterpret_cast<uintptr_t>(rows) % sizeof(uint32_t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((sets + kWarps - 1) / kWarps);
  nms_sweep_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<uint8_t*>(keep), static_cast<int>(sets),
      static_cast<int>(n), static_cast<int>(words));
  return static_cast<int>(cudaGetLastError());
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
