// Kernel F: general Snappy decode of any conforming stream.
//
// Replaces hap_tpu/snappy/pallas_general.py:_decode_any_streams (the TPU
// kernel; of its four scheduling bodies only the semantics are kept). It is
// the general form of kernel C (lz_decode.cu): one warp per chunk walks the
// chunk's stream row in order, every lane reading the same tag bytes, and
// the warp moves each element's bytes -- literals 32 bytes per step, a copy
// with offset d as out[p + j] = out[p - d + (j mod d)], which is right for
// every d >= 1 (an overlapping copy repeats its last d bytes) because each
// source byte lies before p. __syncwarp orders one element's stores before
// the next element's loads.
//
// Rules, exactly the TPU kernel's (_decode_varint_preamble and
// _parse_element): the preamble is a varint of at most 5 bytes (a 5th byte
// below 8) equal to out_len, no longer than the stream, with out_len <=
// S_max; a literal has a 1-5 byte header (lengths up to 2^32), copy-1 has
// length 4-11 and an 11-bit offset, copy-2 and copy-4 length 1-64 and a
// 16/32-bit offset; each element must fit the stream (cursor + header +
// literal bytes <= comp_len) and the output (produced + length <= out_len),
// and a copy's offset must be 1..produced. The stream is ok when the walk
// ends exactly at comp_len with exactly out_len bytes produced. The sums
// are 64-bit, so a huge literal length is rejected, not wrapped. The walk
// stops at the first broken rule and the rest of the row is zeroed (bytes
// [produced, S_max) are always zero), so the kernel and its plain version
// agree byte for byte on corrupt streams. Stream bytes at or past the row
// width B read as 0.
//
// What bounds it on this card: the serial element chain (each tag's
// position depends on the previous element's length), one dependent
// round trip to memory per element, not its few-microsecond bytes bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // chunks per block

__global__ void general_decode_kernel(const uint8_t* __restrict__ comp,
                                      int B,
                                      const int32_t* __restrict__ comp_len,
                                      const int32_t* __restrict__ out_len,
                                      uint8_t* out, bool* __restrict__ ok,
                                      int S_max, int C) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const uint8_t* row = comp + (size_t)c * B;
  uint8_t* o = out + (size_t)c * S_max;
  auto rd = [&](long long i) -> uint32_t {
    return (i >= 0 && i < B) ? __ldg(row + i) : 0u;
  };
  const long long clen = comp_len[c], ulen = out_len[c];

  // varint(uncompressed length) preamble, 1-5 bytes
  uint32_t b[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) b[i] = rd(i);
  long long val = b[0] & 127;
  long long hdr = 1;
  bool inc = b[0] >= 128;
  bool good = true;
#pragma unroll
  for (int i = 1; i < 5; ++i) {
    if (i == 4) good = good && (!inc || b[4] < 8);
    if (inc) {
      val += (long long)(b[i] & 127) << (7 * i);
      ++hdr;
    }
    inc = inc && b[i] >= 128;
  }
  good = good && !inc && val == ulen && hdr <= clen && ulen <= S_max;

  long long cur = hdr, op = 0;
  while (good && cur < clen) {
    const uint32_t tag = rd(cur), b1 = rd(cur + 1), b2 = rd(cur + 2),
                   b3 = rd(cur + 3), b4 = rd(cur + 4);
    const uint32_t kind = tag & 3, len6 = tag >> 2;
    long long elen, in_need, off = 0;
    int ehdr;
    if (kind == 0) {
      ehdr = len6 < 60 ? 1 : (int)len6 - 58;
      const long long ext = (long long)b1 + (len6 >= 61 ? b2 << 8 : 0) +
                            (len6 >= 62 ? b3 << 16 : 0) +
                            (len6 >= 63 ? (long long)b4 << 24 : 0);
      elen = len6 < 60 ? len6 + 1 : ext + 1;
      in_need = ehdr + elen;
    } else {
      elen = kind == 1 ? 4 + (len6 & 7) : (len6 & 63) + 1;
      off = kind == 1   ? (long long)(((tag >> 5) << 8) | b1)
            : kind == 2 ? (long long)(b1 | (b2 << 8))
                        : (long long)b1 | ((long long)b2 << 8) |
                              ((long long)b3 << 16) | ((long long)b4 << 24);
      ehdr = kind == 1 ? 2 : (kind == 2 ? 3 : 5);
      in_need = ehdr;
    }
    if (cur + in_need > clen || op + elen > ulen ||
        (kind != 0 && (off < 1 || off > op))) {
      good = false;
      break;
    }
    const int p = (int)op, n = (int)elen;
    if (kind == 0) {
      const long long src = cur + ehdr;
      for (int j = lane; j < n; j += 32) o[p + j] = (uint8_t)rd(src + j);
    } else {
      const int d = (int)off;
      for (int j = lane; j < n; j += 32) o[p + j] = o[p - d + j % d];
    }
    cur += in_need;
    op += elen;
    __syncwarp();
  }
  if (good && (cur != clen || op != ulen)) good = false;
  for (long long j = op + lane; j < S_max; j += 32) o[j] = 0;
  if (lane == 0) ok[c] = good;
}

}  // namespace

extern "C" int hap_general_decode(const void* comp, int B,
                                  const void* comp_len, const void* out_len,
                                  void* out, void* ok, int S_max, int C,
                                  void* stream) {
  if (C > 0)
    general_decode_kernel<<<(C + kWarps - 1) / kWarps, 32 * kWarps, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)comp, B, (const int32_t*)comp_len,
        (const int32_t*)out_len, (uint8_t*)out, (bool*)ok, S_max, C);
  return (int)cudaGetLastError();
}
