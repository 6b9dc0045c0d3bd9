// Kernel C: frame-direct decode of the LZ profile's Snappy chunk streams.
//
// Replaces hap_tpu/snappy/pallas_lz.py:decode_lz_streams_from_frame (the TPU
// kernel). One warp per compressed chunk walks its stream in order: the
// element chain is serial (each tag's position depends on the previous
// element's length), so every lane reads the same tag bytes and the warp
// moves each element's bytes in parallel -- up to 32 literal bytes per
// step, and a copy-2 element (offset d >= 8, length <= 64) as
// out[p + j] = out[p - d + j % d], which is also right for overlapping
// copies because every source byte lies before p. __syncwarp orders one
// element's stores before the next element's loads.
//
// Rules, as the TPU kernel's: the stream must start with varint(S); only
// literals with 1-3 byte tags and copy-2 elements with 8 <= d <= output
// position are accepted (copy-1, copy-4, 4-byte literal lengths and d < 8
// flag the chunk not-ok); the stream must produce exactly S bytes and end
// exactly at its size-table length. A chunk that breaks a rule stops
// there and the rest of its row is zeroed. Every frame read is bounds
// checked (bytes outside the frame read as 0). The walk also stops at an
// element that would read past the stream's end or write past S: the TPU
// kernel walks on there, but its cursor only grows, so such a chunk ends
// not-ok either way.
//
// Bound on this card: the serial element chain -- one dependent round trip
// to memory per element -- not bytes. A 4K frame has 64 chunks, fewer
// warps than the card has SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint8_t rd(const uint8_t* f, long long F,
                                      long long i) {
  return (i >= 0 && i < F) ? f[i] : 0;
}

__global__ void lz_decode_kernel(const uint8_t* __restrict__ frame,
                                 long long F, const int32_t* __restrict__ pos,
                                 const int32_t* __restrict__ csizes,
                                 const bool* __restrict__ is_comp,
                                 uint8_t* out, bool* __restrict__ ok, int S) {
  const int c = blockIdx.x;
  if (!is_comp[c]) return;
  const int lane = threadIdx.x;
  uint8_t* o = out + (size_t)c * S;
  const long long off = pos[c];
  const long long end = off + (long long)csizes[c];

  bool good = true;
  int P = 0;
  for (uint32_t v = (uint32_t)S;;) {  // preamble must be varint(S)
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) b |= 0x80;
    if (rd(frame, F, off + P) != b) good = false;
    ++P;
    if (!v) break;
  }
  long long cur = off + P;
  int outp = 0;
  while (good && outp < S) {
    if (cur >= end) { good = false; break; }
    const int tag = rd(frame, F, cur);
    const int b1 = rd(frame, F, cur + 1);
    const int b2 = rd(frame, F, cur + 2);
    const int kind = tag & 3, t6 = tag >> 2;
    if (kind == 0) {
      int tl, n;
      if (t6 < 60) { tl = 1; n = t6 + 1; }
      else if (t6 == 60) { tl = 2; n = b1 + 1; }
      else if (t6 == 61) { tl = 3; n = (b1 | (b2 << 8)) + 1; }
      else { good = false; break; }
      if (cur + tl + n > end || outp + n > S) { good = false; break; }
      for (int j = lane; j < n; j += 32) o[outp + j] = rd(frame, F, cur + tl + j);
      cur += tl + n;
      outp += n;
    } else if (kind == 2) {
      const int d = b1 | (b2 << 8), n = t6 + 1;
      if (cur + 3 > end || d < 8 || d > outp || outp + n > S) {
        good = false;
        break;
      }
      for (int j = lane; j < n; j += 32) o[outp + j] = o[outp - d + j % d];
      cur += 3;
      outp += n;
    } else {
      good = false;
      break;
    }
    __syncwarp();
  }
  if (good && cur != end) good = false;
  if (!good)
    for (int j = outp + lane; j < S; j += 32) o[j] = 0;
  if (lane == 0) ok[c] = good;
}

}  // namespace

extern "C" int hap_lz_decode(const void* frame, long long frame_len,
                             const void* pos, const void* csizes,
                             const void* is_comp, void* out, void* ok, int C,
                             int S, void* stream) {
  if (C > 0)
    lz_decode_kernel<<<C, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frame, frame_len, (const int32_t*)pos,
        (const int32_t*)csizes, (const bool*)is_comp, (uint8_t*)out,
        (bool*)ok, S);
  return (int)cudaGetLastError();
}
