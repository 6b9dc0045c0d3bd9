// Kernel B: the frame stitch -- header plus C chunk streams back to back.
//
// Replaces hap_tpu/snappy/pallas_kernels.py:stitch_streams (the TPU kernel).
// Gather form: every output byte is written exactly once. Each thread owns
// 16 consecutive output bytes; it finds the chunk covering its first byte
// by binary search over the chunk positions (staged in shared memory),
// walks forward across chunk boundaries, and stores the 16 bytes as one
// vector. Bytes below header_len come from the header; bytes no chunk
// covers are 0. A chunk's source row is its compressed stream or its raw
// payload bytes, chosen per chunk, so no merged stream buffer is built.
//
// Bound on this card: bytes moved (the frame written once, the header and
// each chunk's emitted bytes read once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void stitch_kernel(const uint8_t* __restrict__ header,
                              const int32_t* __restrict__ header_len,
                              const uint8_t* __restrict__ comp, int comp_stride,
                              const uint8_t* __restrict__ chunks,
                              int chunk_stride,
                              const bool* __restrict__ src_comp,
                              const int32_t* __restrict__ q,
                              const int32_t* __restrict__ len, int C,
                              uint8_t* __restrict__ out, long long out_len) {
  extern __shared__ int32_t smem[];
  int32_t* sq = smem;
  int32_t* sl = smem + C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sq[i] = q[i];
    sl[i] = len[i];
  }
  __syncthreads();
  const long long hlen = *header_len;
  const long long step = (long long)gridDim.x * blockDim.x * 16;
  for (long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 16;
       base < out_len; base += step) {
    int lo = 0, hi = C - 1, c = -1;  // last chunk with q[c] <= base
    while (lo <= hi) {
      const int mid = (lo + hi) >> 1;
      if (sq[mid] <= base) { c = mid; lo = mid + 1; } else { hi = mid - 1; }
    }
    alignas(16) uint8_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const long long i = base + j;
      uint8_t b = 0;
      if (i < hlen) {
        b = header[i];
      } else {
        while (c + 1 < C && i >= sq[c + 1]) ++c;
        if (c >= 0) {
          const long long o = i - sq[c];
          if (o >= 0 && o < sl[c]) {
            if (src_comp[c]) {
              if (o < comp_stride) b = comp[(size_t)c * comp_stride + o];
            } else if (o < chunk_stride) {
              b = chunks[(size_t)c * chunk_stride + o];
            }
          }
        }
      }
      v[j] = b;
    }
    if (base + 16 <= out_len) {
      *reinterpret_cast<uint4*>(out + base) = *reinterpret_cast<uint4*>(v);
    } else {
      for (int j = 0; base + j < out_len; ++j) out[base + j] = v[j];
    }
  }
}

}  // namespace

extern "C" int hap_stitch(const void* header, const void* header_len,
                          const void* comp, int comp_stride, const void* chunks,
                          int chunk_stride, const void* src_comp, const void* q,
                          const void* lengths, int C, void* out,
                          long long out_len, void* stream) {
  if (out_len > 0) {
    const int threads = 256;
    long long blocks = (out_len + threads * 16 - 1) / (threads * 16);
    if (blocks > 4096) blocks = 4096;
    stitch_kernel<<<(int)blocks, threads, 2 * C * sizeof(int32_t),
                    (cudaStream_t)stream>>>(
        (const uint8_t*)header, (const int32_t*)header_len,
        (const uint8_t*)comp, comp_stride, (const uint8_t*)chunks,
        chunk_stride, (const bool*)src_comp, (const int32_t*)q,
        (const int32_t*)lengths, C, (uint8_t*)out, out_len);
  }
  return (int)cudaGetLastError();
}
