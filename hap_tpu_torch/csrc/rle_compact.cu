// Kernel E: compose and place the structured (RLE) profile's unit emissions
// straight from the chunk payload.
//
// Replaces hap_tpu/snappy/pallas_kernels.py:compact_streams_from_data (the
// TPU kernel, which walks the units of 8 chunks in order and merges each
// emission into a VMEM-resident output block). Here the byte positions are
// absolute (an exclusive cumsum of the unit sizes, computed before the
// launch), so every emission is independent: grid (n_units + kZeroBlocks,
// C), one block per unit of a chunk, byte stores at the unit's position.
// The flavor is recovered from the size, as the TPU kernel does: the
// literal size gives the literal (tag, then the unit's bytes), any other
// size the unit's run pattern -- the copy pattern, or for unit 0 the seeded
// pattern with its first G bytes after the seed tag; for the tail the tail
// copy pattern after full units, the seeded tail pattern when the tail is
// the whole chunk and longer than G, else nothing. A unit writes `size`
// bytes; those past its composition are 0. The last kZeroBlocks blocks of
// each chunk write the zeros outside the units: before positions[c][0]
// and after the last unit's end. Units are assumed back to
// back; bytes outside the row are dropped.
//
// Bound on this card: bytes moved -- each literal unit read once, every
// output byte written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "rle_profile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kZeroBlocks = 8;

__device__ inline uint8_t run_byte(const rle::Profile& p, bool seeded,
                                   int run_len, const uint8_t* unit, int j) {
  // seeded: [seed tag][G seed bytes][copies over run_len - G]
  // else:   [copies over run_len]
  if (run_len <= 0) return 0;
  if (seeded) {
    if (j == 0) return (uint8_t)((p.G - 1) << 2);
    if (j <= p.G) return unit[j - 1];
    const int k = j - 1 - p.G;
    return k < rle::copy_run_len(run_len - p.G)
               ? rle::copy_run_byte(run_len - p.G, p.G, k) : 0;
  }
  return j < rle::copy_run_len(run_len) ? rle::copy_run_byte(run_len, p.G, j)
                                        : 0;
}

__global__ void rle_compact_kernel(const uint8_t* __restrict__ data,
                                   const int32_t* __restrict__ positions,
                                   const int32_t* __restrict__ sizes,
                                   uint8_t* __restrict__ out, int S, int G,
                                   int out_width) {
  const rle::Profile p = rle::make_profile(S, G);
  const int c = blockIdx.y;
  const int u = blockIdx.x;
  uint8_t* o = out + (size_t)c * out_width;
  const int32_t* pos = positions + (size_t)c * p.n_units;
  const int32_t* size = sizes + (size_t)c * p.n_units;

  if (u >= p.n_units) {  // zeros outside the units
    const long long head =
        min((long long)out_width, max(0LL, (long long)pos[0]));
    const long long end = (long long)pos[p.n_units - 1] + size[p.n_units - 1];
    const long long tail0 = min((long long)out_width, max(head, end));
    const long long n = head + (out_width - tail0);
    for (long long i = (long long)(u - p.n_units) * kThreads + threadIdx.x;
         i < n; i += (long long)kZeroBlocks * kThreads)
      o[i < head ? i : tail0 + (i - head)] = 0;
    return;
  }

  const bool is_tail = p.tail && u == p.n_full;
  const int length = is_tail ? p.tail : rle::kUnit;
  const int hdr = is_tail ? p.tail_hdr : rle::lit_tag_len(rle::kUnit);
  const int lit_size = is_tail ? p.tail_lit_size : p.emit_max;
  const uint8_t* unit = data + (size_t)c * S + (size_t)u * rle::kUnit;
  const long long at = pos[u];
  const int n = (int)min((long long)size[u], max(0LL, out_width - at));
  const bool lit = size[u] == lit_size;
  // the run pattern of this unit
  bool seeded;
  int run_len;
  if (is_tail) {
    seeded = p.tail_seeded;
    run_len = (p.n_full || p.tail_seeded) ? p.tail : 0;
  } else {
    seeded = u == 0;
    run_len = rle::kUnit;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    uint8_t b;
    if (lit)
      b = j < hdr ? rle::lit_tag_byte(length, j)
                  : (j - hdr < length ? unit[j - hdr] : 0);
    else
      b = run_byte(p, seeded, run_len, unit, j);
    const long long d = at + j;
    if (d >= 0 && d < out_width) o[d] = b;
  }
}

}  // namespace

extern "C" int hap_rle_compact(const void* data, const void* positions,
                               const void* sizes, void* out, int C, int S,
                               int G, int out_width, void* stream) {
  const rle::Profile p = rle::make_profile(S, G);
  if (C > 0 && p.n_units > 0) {
    dim3 grid(p.n_units + kZeroBlocks, C);
    rle_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)positions,
        (const int32_t*)sizes, (uint8_t*)out, S, G, out_width);
  }
  return (int)cudaGetLastError();
}
