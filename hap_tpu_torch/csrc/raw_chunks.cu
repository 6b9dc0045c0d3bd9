// Kernel D: raw (stored) chunks copied straight out of the frame.
//
// Replaces the raw-chunk path of hap_tpu/snappy/pallas_kernels.py:
// decode_streams_from_frame (the TPU kernel's strided copy with its
// cursor == size check). The structured-profile walk of that kernel is not
// part of this source. Grid: (tile of the chunk, chunk); each block copies
// one tile of S bytes from frame[pos[c]:] into row c, lanes on neighbouring
// bytes. ok[c] is csizes[c] == S for raw chunks (a stored chunk holds
// exactly S bytes) and true for compressed chunks, whose rows are left for
// the LZ decoder. Bytes outside the frame read as 0.
//
// Bound on this card: bytes moved (each raw chunk read once and written
// once).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4096;

__global__ void raw_chunks_kernel(const uint8_t* __restrict__ frame,
                                  long long F, const int32_t* __restrict__ pos,
                                  const int32_t* __restrict__ csizes,
                                  const bool* __restrict__ is_comp,
                                  uint8_t* __restrict__ out,
                                  bool* __restrict__ ok, int S) {
  const int c = blockIdx.y;
  const bool comp = is_comp[c];
  if (blockIdx.x == 0 && threadIdx.x == 0) ok[c] = comp || csizes[c] == S;
  if (comp) return;
  const long long p0 = pos[c];
  uint8_t* o = out + (size_t)c * S;
  const int base = blockIdx.x * kTile;
  const int stop = min(base + kTile, S);
  for (int i = base + threadIdx.x; i < stop; i += blockDim.x) {
    const long long src = p0 + i;
    o[i] = (src >= 0 && src < F) ? frame[src] : 0;
  }
}

}  // namespace

extern "C" int hap_raw_chunks(const void* frame, long long frame_len,
                              const void* pos, const void* csizes,
                              const void* is_comp, void* out, void* ok, int C,
                              int S, void* stream) {
  if (C > 0 && S > 0) {
    dim3 grid((S + kTile - 1) / kTile, C);
    raw_chunks_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frame, frame_len, (const int32_t*)pos,
        (const int32_t*)csizes, (const bool*)is_comp, (uint8_t*)out,
        (bool*)ok, S);
  }
  return (int)cudaGetLastError();
}
