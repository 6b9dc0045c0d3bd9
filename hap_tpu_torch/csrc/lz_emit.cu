// Kernel A: LZ Snappy stream emission from the planner's piece tables.
//
// Replaces hap_tpu/snappy/pallas_lz.py:emit_lz_streams (the TPU kernel).
// Every piece record carries its own output position (the planner's
// exclusive prefix sum), so pieces are independent: the grid is one block
// per (segment, chunk) plus one block per chunk for the varint preamble and
// the zero tail, and each warp of a block emits whole pieces -- literal
// tags plus payload bytes copied lane by lane, or copy-2 trains built from
// the record's scalars. Piece regions are disjoint, so no block
// synchronises.
//
// Bound on this card: bytes moved (each chunk's stream written once, the
// literal payload bytes read once); the work per byte is a few integer ops.
// The design keeps every piece's bytes in one warp so loads and stores of
// neighbouring lanes fall on neighbouring addresses.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 32;   // piece slots per 256-word segment
constexpr int kWarps = 8;

__device__ int varint_bytes(uint32_t v, uint8_t* b) {
  int n = 0;
  do {
    uint8_t x = v & 0x7F;
    v >>= 7;
    b[n++] = v ? (x | 0x80) : x;
  } while (v);
  return n;
}

__global__ void lz_emit_kernel(const uint8_t* __restrict__ data,
                               const int32_t* __restrict__ tlit,
                               const int32_t* __restrict__ tcopy,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ comp_len,
                               uint8_t* __restrict__ out, int S, int nseg,
                               int bound) {
  const int c = blockIdx.y;
  const int s = blockIdx.x;
  uint8_t* o = out + (size_t)c * bound;

  if (s == nseg) {  // preamble + zeros past the last piece
    uint8_t pre[5];
    const int P = varint_bytes((uint32_t)S, pre);
    if (threadIdx.x < P) o[threadIdx.x] = pre[threadIdx.x];
    int end = comp_len[c];
    end = end < P ? P : (end > bound ? bound : end);
    for (int i = end + threadIdx.x; i < bound; i += blockDim.x) o[i] = 0;
    return;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int32_t* cnt = counts + ((size_t)c * nseg + s) * 2;
  const int nlit = min(cnt[0], kSlots);
  const int ncopy = min(cnt[1], kSlots);
  const size_t rec0 = ((size_t)c * nseg + s) * kSlots;
  const uint8_t* src = data + (size_t)c * S;

  for (int k = warp; k < ncopy; k += kWarps) {
    const int32_t w0 = tcopy[(rec0 + k) * 2];
    const int32_t w1 = tcopy[(rec0 + k) * 2 + 1];
    const int p = w0 & 0xFFFFF;
    const int nel = (w0 >> 20) & 0x7FF;
    const int d = w1 & 0x1FFFF;
    const int tail = (w1 >> 17) & 0x7F;
    const int n = 3 * nel;
    for (int j = lane; j < n; j += 32) {
      const int e = j / 3, r = j - 3 * e;
      uint8_t b;
      if (r == 0) b = (uint8_t)(2 | (((e == nel - 1 ? tail : 64) - 1) << 2));
      else if (r == 1) b = (uint8_t)(d & 0xFF);
      else b = (uint8_t)(d >> 8);
      if (p + j < bound) o[p + j] = b;
    }
  }
  for (int k = warp; k < nlit; k += kWarps) {
    const int32_t w0 = tlit[(rec0 + k) * 2];
    const int32_t w1 = tlit[(rec0 + k) * 2 + 1];
    const int p = w0 & 0xFFFFF;
    const int blen = (w0 >> 20) & 0x7FF;
    const int tl = (w1 >> 20) & 3;
    const int ip = w1 & 0xFFFFF;
    const int nm1 = blen - 1;
    if (lane < tl && p + lane < bound) {
      uint8_t b;
      if (lane == 0) b = tl == 1 ? (uint8_t)(nm1 << 2) : (tl == 2 ? 240 : 244);
      else if (lane == 1) b = tl == 2 ? (uint8_t)nm1 : (uint8_t)(nm1 & 0xFF);
      else b = (uint8_t)(nm1 >> 8);
      o[p + lane] = b;
    }
    for (int j = lane; j < blen; j += 32) {
      const int q = p + tl + j;
      if (q < bound && ip + j < S) o[q] = src[ip + j];
    }
  }
}

}  // namespace

extern "C" int hap_lz_emit(const void* data, const void* tables_lit,
                           const void* tables_copy, const void* counts,
                           const void* comp_len, void* out, int C, int S,
                           int nseg, int bound, void* stream) {
  if (C > 0) {
    dim3 grid(nseg + 1, C);
    lz_emit_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, (const int32_t*)tables_lit,
        (const int32_t*)tables_copy, (const int32_t*)counts,
        (const int32_t*)comp_len, (uint8_t*)out, S, nseg, bound);
  }
  return (int)cudaGetLastError();
}
