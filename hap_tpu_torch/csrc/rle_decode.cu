// Kernel D(ii): frame-direct walk of the structured (RLE) profile's Snappy
// chunk streams.
//
// Replaces the structured walk of
// hap_tpu/snappy/pallas_kernels.py:decode_streams_from_frame (the TPU
// kernel: DMA a tile of 8 chunks' bytes into VMEM, then step every chunk's
// cursor through its units with int32 byte lanes, 4 chains interleaved).
// Raw chunks are kernel D's (raw_chunks.cu); this kernel writes only the
// rows and ok flags of the compressed chunks.
//
// One block per compressed chunk. The stream (at most the profile's bound,
// 129,699 B at 4K) is first staged into shared memory with 16-byte loads,
// when it fits the block's shared memory; larger chunks are read from
// device memory in place. The serial part of the walk is only the cursor:
// one tag byte per unit decides its flavor and so its advance, so thread 0
// resolves the chain (<= 33 steps at 4K) and records each unit's cursor,
// flavor and the stream position of the G bytes a run repeats (the seed,
// or the last G bytes of the literal unit before it). Then all threads
// check every unit's static tag pattern, and expand the units in parallel,
// 8 output bytes per store.
//
// Rules, as the TPU kernel's: the stream starts with varint(S); unit 0 is
// seeded (tag (G-1)<<2) or a literal; later full units are copies (tag
// 254) or literals; the tail is a tail copy after full units, seeded when
// it is the whole chunk and longer than G, else a literal; every tag byte
// equals its pattern; the units end exactly at the stream's length. A
// stream that breaks a rule gets a row of zeros and ok false (the plain
// version does the same). Stream bytes past its length (or outside the
// frame) read as 0: any read past the stream's end already makes the final
// cursor overshoot it, so this changes no verdict.
//
// Bound on this card: bytes moved -- each compressed stream read once and
// its decoded row written once. A 4K frame gives at most 64 blocks, fewer
// than the card's 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "rle_profile.cuh"

namespace {

constexpr int kThreads = 512;
enum : uint8_t { kLit = 0, kCopy = 1, kSeed = 2 };

// Byte i of one chunk's stream: 0 outside [0, avail) and outside the frame.
struct Reader {
  const uint8_t* staged;  // shared-memory copy (stream byte i at [i]), or null
  const uint8_t* frame;
  long long F, off;
  int avail;
  __device__ __forceinline__ uint8_t operator()(int i) const {
    if (i < 0 || i >= avail) return 0;
    if (staged) return staged[i];
    const long long a = off + i;
    return (a >= 0 && a < F) ? frame[a] : 0;
  }
};

__host__ __device__ inline size_t meta_bytes(int n_units) {
  return ((size_t)n_units * 9 + 15) & ~(size_t)15;
}

__global__ void __launch_bounds__(kThreads)
rle_decode_kernel(const uint8_t* __restrict__ frame, long long F,
                  const int32_t* __restrict__ pos,
                  const int32_t* __restrict__ csizes,
                  const bool* __restrict__ is_comp, uint8_t* __restrict__ out,
                  bool* __restrict__ ok, int S, int G, int stage) {
  const int c = blockIdx.x;
  if (!is_comp[c]) return;
  const rle::Profile p = rle::make_profile(S, G);
  const int tid = threadIdx.x;
  extern __shared__ __align__(16) uint8_t smem[];
  int* cur = (int*)smem;
  int* gsrc = cur + p.n_units;
  uint8_t* flav = (uint8_t*)(gsrc + p.n_units);
  __shared__ int s_bad;

  const long long off = pos[c];
  const int clen = csizes[c];
  Reader rd{nullptr, frame, F, off, max(0, min(clen, p.bound))};

  if (stage) {  // stream bytes [0, avail) -> shared memory, 16 B a load
    uint8_t* buf = smem + meta_bytes(p.n_units);
    const int sh = (int)(off & 15);
    const long long a0 = off - sh;  // 16-byte aligned frame offset
    const bool vec = ((uintptr_t)frame & 15) == 0;
    const int nw = (sh + rd.avail + 15) / 16;
    for (int w = tid; w < nw; w += kThreads) {
      const long long a = a0 + 16LL * w;
      if (vec && a >= 0 && a + 16 <= F) {
        *(uint4*)(buf + 16 * w) = *(const uint4*)(frame + a);
      } else {
        for (int k = 0; k < 16; ++k)
          buf[16 * w + k] = (a + k >= 0 && a + k < F) ? frame[a + k] : 0;
      }
    }
    rd.staged = buf + sh;
    __syncthreads();
  }

  if (tid == 0) {  // the cursor chain
    bool bad = false;
    for (int k = 0; k < p.P; ++k) bad |= rd(k) != rle::varint_byte(S, k);
    const uint8_t seed_tag = (uint8_t)((G - 1) << 2);
    const uint8_t copy_tag = rle::copy_run_byte(rle::kUnit, G, 0);
    int cursor = p.P, g = 0;
    for (int u = 0; u < p.n_full; ++u) {
      const uint8_t tag = rd(cursor);
      uint8_t f;
      int adv;
      if (u == 0 && tag == seed_tag) {
        f = kSeed;
        g = cursor + 1;
        adv = p.seed_size;
      } else if (u > 0 && tag == copy_tag) {
        f = kCopy;
        adv = p.copy_len;
      } else {
        f = kLit;
        adv = p.emit_max;
      }
      cur[u] = cursor;
      flav[u] = f;
      gsrc[u] = g;
      if (f == kLit) g = cursor + (p.emit_max - rle::kUnit) + rle::kUnit - G;
      cursor += adv;
    }
    if (p.tail) {
      const uint8_t tag = rd(cursor);
      uint8_t f;
      int adv;
      if (p.n_full && tag == rle::copy_run_byte(p.tail, G, 0)) {
        f = kCopy;
        adv = p.tail_copy_len;
      } else if (p.tail_seeded && tag == seed_tag) {
        f = kSeed;
        g = cursor + 1;
        adv = p.tail_seed_size;
      } else {
        f = kLit;
        adv = p.tail_lit_size;
      }
      cur[p.n_full] = cursor;
      flav[p.n_full] = f;
      gsrc[p.n_full] = g;
      cursor += adv;
    }
    s_bad = bad || cursor != clen;
  }
  __syncthreads();

  bool bad = false;  // every unit's static tag pattern
  for (int u = tid; u < p.n_units; u += kThreads) {
    const int L = (p.tail && u == p.n_full) ? p.tail : rle::kUnit;
    const int c0 = cur[u];
    if (flav[u] == kLit) {
      for (int k = 0; k < rle::lit_tag_len(L); ++k)
        bad |= rd(c0 + k) != rle::lit_tag_byte(L, k);
    } else if (flav[u] == kCopy) {
      for (int k = 0; k < rle::copy_run_len(L); ++k)
        bad |= rd(c0 + k) != rle::copy_run_byte(L, G, k);
    } else {
      for (int k = 0; k < rle::copy_run_len(L - G); ++k)
        bad |= rd(c0 + 1 + G + k) != rle::copy_run_byte(L - G, G, k);
    }
  }
  const bool good = !__syncthreads_or(bad) && !s_bad;

  uint8_t* o = out + (size_t)c * S;
  for (int w = tid; w < S / 8; w += kThreads) {
    const int b = 8 * w;
    const int u = b / rle::kUnit;
    const int j = b - u * rle::kUnit;
    unsigned long long v = 0;
    if (good) {
      if (flav[u] == kLit) {
        const int h = (p.tail && u == p.n_full) ? p.tail_hdr
                                                 : p.emit_max - rle::kUnit;
        const int s = cur[u] + h + j;
        for (int k = 0; k < 8; ++k)
          v |= (unsigned long long)rd(s + k) << (8 * k);
      } else {
        const int s = gsrc[u];
        for (int k = 0; k < 8; ++k)
          v |= (unsigned long long)rd(s + (j + k) % G) << (8 * k);
      }
    }
    *(unsigned long long*)(o + b) = v;
  }
  if (tid == 0) ok[c] = good;
}

}  // namespace

extern "C" int hap_rle_decode(const void* frame, long long frame_len,
                              const void* pos, const void* csizes,
                              const void* is_comp, void* out, void* ok, int C,
                              int S, int G, void* stream) {
  if (C <= 0 || S <= 0) return (int)cudaGetLastError();
  const rle::Profile p = rle::make_profile(S, G);
  const size_t meta = meta_bytes(p.n_units);
  const size_t staged = meta + (size_t)p.bound + 32;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int stage = staged <= (size_t)optin;
  const size_t smem = stage ? staged : meta;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rle_decode_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  rle_decode_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frame, frame_len, (const int32_t*)pos,
      (const int32_t*)csizes, (const bool*)is_comp, (uint8_t*)out, (bool*)ok,
      S, G, stage);
  return (int)cudaGetLastError();
}
