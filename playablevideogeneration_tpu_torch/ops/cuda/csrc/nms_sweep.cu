// Greedy NMS of score-sorted candidate sets, from their boxes to the keep
// mask, in two kernels on one stream.
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// nms_mask after its argsort
// (playablevideogeneration_tpu/evaluation/metrics/frcnn.py:277-301): the
// IoU of the sorted boxes, the > threshold test and the lax.scan, which
// XLA compiles into the detector's device program.  For each of S sets of
// n <= 1024 boxes (x1, y1, x2, y2), already sorted by score, candidate i
// is kept unless a kept candidate before it overlaps it (IoU > threshold);
// the output is the (S, n) keep mask in score order, one byte per
// candidate.  The result is boolean, so the kernels equal their plain
// version (ops/cuda/nms_sweep.py) bit for bit: each intersection and union
// takes the IEEE f32 operations of box_iou in its order, with the _rn
// intrinsics, which nvcc never contracts into an FMA, and maximum and
// minimum that return a NaN operand as torch.maximum does.  The test
// fl(inter / union) > t then needs the division only where the quotient
// lies within one ulp above t, on it, or is NaN: union > 0, and an FMA
// rounds the exact inter - t * union once, which keeps its sign (a 0 from
// underflow goes to the division too).  So inter - t * union < 0 means
// the quotient is below t and rounds to t or less, and inter - t' * union
// > 0, with t' the float after t, means it is above t' and rounds to t' or
// more; between the two the division decides.
//
// 1. nms_mask_kernel writes the rows of the IoU > threshold matrix packed
//    to bits: row i holds `words` 32-bit words, column j in bit j % 32 of
//    word j / 32, as the plain version packs them.  A warp computes one
//    32 x 32 tile: lane l holds row box 32r + l in registers and reads
//    the tile's 32 column boxes as broadcasts from shared memory.  Only
//    the tiles at or right of the diagonal (c >= r) are computed: the
//    sweep never reads bit j of row i for j <= i, and those words are
//    left unwritten.  Bits for columns past n may be set: they stand for
//    no candidate, and the sweep writes no keep for them.  Bound: n(n -
//    1) / 2 IoUs per set at the f32 rate (about 32 M for the 64 sets of
//    1000 of a 16-frame RPN call).
// 2. nms_sweep_kernel sweeps each set's rows, one warp per set: lane l
//    owns bits 32l .. 32l + 31 of the suppressed mask.  The candidates go
//    in chunks of 32 rows, whose words are contiguous.  The warp fetches
//    a chunk in 16-byte pieces into registers while it sweeps the chunk
//    before, then lays it out in one of two tiles in shared memory, so
//    the wait on L2 (the rows were written just before, and the 8 MB of
//    the largest call stay there) overlaps those steps, with few loads in
//    flight.  Within a chunk every lane holds the owner's word of each
//    row (word `chunk`), so a step is two shifts and a masked OR in
//    registers, with no branch.  Its floor is the chain of n dependent
//    steps per set, not its bytes.
//
// The sweep also takes rows packed by the plain version, padded to a
// multiple of 4 words, so the two halves can be timed apart.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxWords = 32;  // n <= 1024 = 32 lanes x 32 bits
constexpr int kMaskWarps = 4;  // tiles per block of the mask kernel
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum and torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// box_iou's operations: lt = max, rb = min, wh = clamp(rb - lt, min=0),
// inter = w * h, union = clamp((area_a + area_b) - inter, min=1e-9).
__device__ __forceinline__ void intersection_union(float4 a, float area_a, float4 b,
                                                   float area_b, float& inter, float& uni) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  inter = __fmul_rn(w, h);
  uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
}

__global__ void __launch_bounds__(kMaskWarps * 32)
    nms_mask_kernel(const float4* __restrict__ boxes, uint32_t* __restrict__ rows, int n,
                    int words, int tiles, float threshold, float above) {
  __shared__ float4 column_box[kMaskWarps][32];
  __shared__ float column_area[kMaskWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int k = blockIdx.y * kMaskWarps + warp;
  if (k >= tiles) return;  // a whole warp leaves; nothing below syncs the block
  // The k-th tile of the upper triangle, row-major: (r, c), c >= r.
  const int row_tiles = (n + 31) / 32;
  int r = 0;
  while (k >= row_tiles - r) {
    k -= row_tiles - r;
    ++r;
  }
  const int c = r + k;
  const float4* set_boxes = boxes + static_cast<int64_t>(blockIdx.x) * n;
  const int i = 32 * r + lane;
  const int j = 32 * c + lane;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a = i < n ? set_boxes[i] : zero;
  const float4 b = j < n ? set_boxes[j] : zero;
  const float area_a = area(a);
  column_box[warp][lane] = b;
  column_area[warp][lane] = area(b);
  __syncwarp();
  // inter / union > threshold, strictly, as the comment at the top sets
  // out (`above` is the float after `threshold`): settled by the signs of
  // two FMAs, and the pairs that these leave open divided after the loop.
  uint32_t word = 0, open = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    float inter, uni;
    intersection_union(a, area_a, column_box[warp][t], column_area[warp][t], inter, uni);
    const bool over = __fmaf_rn(-above, uni, inter) > 0.0f;
    const bool under = __fmaf_rn(-threshold, uni, inter) < 0.0f;
    word |= static_cast<uint32_t>(over) << t;
    open |= static_cast<uint32_t>(!over && !under) << t;
  }
#pragma unroll 1
  for (; open; open &= open - 1) {  // rare: a quotient within an ulp of the threshold, or NaN
    const int t = __ffs(open) - 1;
    float inter, uni;
    intersection_union(a, area_a, column_box[warp][t], column_area[warp][t], inter, uni);
    word |= static_cast<uint32_t>(__fdiv_rn(inter, uni) > threshold) << t;
  }
  if (i < n) rows[(static_cast<int64_t>(blockIdx.x) * n + i) * words + c] = word;
}

// Chunk `chunk`'s words (its rows, contiguous, starting on 16 bytes: rows
// of a multiple of 4 words) into registers, in 16-byte pieces, the warp's
// lanes in turn.  Words past the chunk's, or of a chunk past the last, are
// zero.
__device__ __forceinline__ void fetch(const uint32_t* __restrict__ base, int chunk, int n,
                                      int words, int lane, uint4 (&stage)[8]) {
  const int chunks = (n + 31) / 32;
  const int count = chunk < chunks ? min(32, n - 32 * chunk) * words : 0;
  const uint4* src =
      reinterpret_cast<const uint4*>(base + static_cast<int64_t>(chunk) * 32 * words);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int piece = lane + 32 * k;
    stage[k] = 4 * piece < count ? __ldg(src + piece) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// `fetch`'s registers into the chunk's tile in shared memory, in its order.
__device__ __forceinline__ void stash(uint32_t* tile, int lane, const uint4 (&stage)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) reinterpret_cast<uint4*>(tile)[lane + 32 * k] = stage[k];
}

__global__ void __launch_bounds__(32)
    nms_sweep_kernel(const uint32_t* __restrict__ rows, uint8_t* __restrict__ keep, int n,
                     int words) {
  __shared__ __align__(16) uint32_t tiles[2][32 * kMaxWords];
  const int lane = threadIdx.x;
  const uint32_t* base = rows + static_cast<int64_t>(blockIdx.x) * n * words;
  uint8_t* out = keep + static_cast<int64_t>(blockIdx.x) * n;
  const int chunks = (n + 31) / 32;
  uint4 stage[8];
  fetch(base, 0, n, words, lane, stage);
  stash(tiles[0], lane, stage);
  fetch(base, 1, n, words, lane, stage);
  __syncwarp();
  uint32_t suppressed = 0;  // bits 32 * lane .. 32 * lane + 31
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const uint32_t* tile = tiles[chunk & 1];
    const int count = min(32, n - 32 * chunk);
    // Rows past n, the words left of this chunk (unwritten by the mask
    // kernel, and never read again) and those past the last column are
    // taken as zero.  The reads stay inside the tile and are masked after,
    // with no branch: a branch around each read made the compiler
    // recompute the tile's address in it, from a special register.
    const uint32_t columns = lane > chunk && lane < chunks ? ~0u : 0u;
    uint32_t row[32], owner[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const uint32_t in = t < count ? ~0u : 0u;
      row[t] = tile[t * words + lane] & in & columns;
      owner[t] = tile[t * words + chunk] & in;
    }
    uint32_t w = __shfl_sync(kFull, suppressed, chunk);
    uint32_t kept = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      // All ones where candidate t is suppressed (bit t of w set), else 0.
      // Candidates past n were given zero rows and are not written.
      const uint32_t hit = static_cast<uint32_t>(static_cast<int32_t>(w << (31 - t)) >> 31);
      kept |= ~hit & (1u << t);
      w |= owner[t] & ~hit;
      suppressed |= row[t] & ~hit;
    }
    if (lane < count) out[32 * chunk + lane] = static_cast<uint8_t>((kept >> lane) & 1u);
    // The next chunk's words, fetched during this chunk, go to the other
    // tile (read last in the chunk before); the one after is fetched.
    __syncwarp();
    stash(tiles[(chunk + 1) & 1], lane, stage);
    __syncwarp();
    fetch(base, chunk + 2, n, words, lane, stage);
  }
}

cudaError_t prepare(int device, int64_t sets, int64_t n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 0 || n > kMaxWords * 32 || sets < 0 || sets >= (int64_t{1} << 31)) {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// boxes: (sets, n) float4, 16-byte aligned; rows: (sets, n, words) uint32
// with words >= ceil(n / 32).  Writes the words at or right of each row's
// diagonal word.  Returns cudaGetLastError() after the launch.
int nms_mask(const void* boxes, void* rows, int64_t sets, int64_t n, int64_t words,
             float threshold, int device, void* stream) {
  cudaError_t err = prepare(device, sets, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sets == 0 || n == 0) return 0;
  const int64_t row_tiles = (n + 31) / 32;
  if (words < row_tiles || words > kMaxWords ||
      reinterpret_cast<uintptr_t>(boxes) % alignof(float4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = row_tiles * (row_tiles + 1) / 2;
  const dim3 grid(static_cast<unsigned>(sets),
                  static_cast<unsigned>((tiles + kMaskWarps - 1) / kMaskWarps));
  nms_mask_kernel<<<grid, kMaskWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<uint32_t*>(rows), static_cast<int>(n),
      static_cast<int>(words), static_cast<int>(tiles), threshold,
      std::nextafter(threshold, INFINITY));
  return static_cast<int>(cudaGetLastError());
}

// rows: (sets, n, words) uint32 words, words a multiple of 4, 16-byte
// aligned; keep: (sets, n) bytes.  Returns cudaGetLastError() after the
// launch.
int nms_sweep(const void* rows, void* keep, int64_t sets, int64_t n, int64_t words, int device,
              void* stream) {
  cudaError_t err = prepare(device, sets, n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sets == 0 || n == 0) return 0;
  if (words < (n + 31) / 32 || words > kMaxWords || words % 4 ||
      reinterpret_cast<uintptr_t>(rows) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nms_sweep_kernel<<<static_cast<unsigned>(sets), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), static_cast<uint8_t*>(keep), static_cast<int>(n),
      static_cast<int>(words));
  return static_cast<int>(cudaGetLastError());
}

const char* pvg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
