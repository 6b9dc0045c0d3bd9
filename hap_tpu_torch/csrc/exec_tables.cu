// Kernel G: replay host-compiled Snappy op tables into decoded chunk rows.
//
// Replaces hap_tpu/snappy/pallas_exec.py:_execute_op_tables (the TPU
// kernel). The host compiler (hap_tpu_torch/snappy/optable.py) has already
// validated each stream, merged and split its elements into pieces of
// 1-128 bytes that never cross a 128-byte output block, and expanded every
// overlapping copy, so a piece's source never overlaps its destination.
// Each piece is two pack_fields words:
//   w0 = pa | pe<<7 | end<<15 | near<<16 | shift<<17,  w1 = source row.
// With a running block index b (advanced by `end`), the piece writes
// out[b*128 + pa, b*128 + pe); with srcl = (pa - shift) & 255 its source is
//   near:            out[dst - (128 + pa - srcl) ...]   (a recent copy)
//   w1 >= nout:      lit[w1*128 + srcl - nout*128 ...]  (literal plane)
//   otherwise:       out[w1*128 + srcl ...]             (a far copy)
// where nout = ceil(S_max / 128).
//
// One warp per chunk walks its pieces in order. Each lane holds one
// piece's words of a group of 32 (one coalesced load per group) and the
// warp broadcasts them with shuffles; the piece's <= 128 bytes move 4 per
// lane, consecutive lanes on consecutive bytes. All lanes read their
// source bytes, then __syncwarp, then write, then __syncwarp again: a
// later piece may read what this one wrote. Every index is clamped into
// its array and writes outside [0, S_max) are dropped, so a malformed
// table gives garbage, never a fault (the TPU kernel's contract). After
// the walk the row's bytes [out_len, S_max) are zeroed, so rows of
// rejected streams (n_ops == 0, out_len == 0) come out all zero. Rows are
// written as bytes; the little-endian u32 word output of the TPU kernel is
// the same memory, so the wrapper only allocates it as int32.
//
// What bounds it on this card: the serial piece chain of each chunk (about
// 1,000-2,700 pieces per 4K chunk, each a dependent read of earlier
// output), not bytes: table + literal + output bytes of a 4K frame move in
// a few microseconds at 3.35 TB/s. A GOP launch gives N*C independent
// warps (512 for 8 4K frames) to fill the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // chunks per block

__global__ void exec_tables_kernel(const int2* __restrict__ ops, int nops,
                                   const int32_t* __restrict__ n_ops,
                                   const uint8_t* __restrict__ lit, int L,
                                   const int32_t* __restrict__ out_len,
                                   uint8_t* out, int S_max, int C) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;
  const int2* w = ops + (size_t)c * nops;
  const uint8_t* l = lit + (size_t)c * L;
  uint8_t* o = out + (size_t)c * S_max;
  const long long nout = (S_max + 127) / 128;
  int n = n_ops[c];
  n = n < 0 ? 0 : (n > nops ? nops : n);

  long long b = 0;  // current 128-byte output block
  for (int base = 0; base < n; base += 32) {
    const int2 mine = (base + lane < n) ? w[base + lane] : make_int2(0, 0);
    const int cnt = min(32, n - base);
    for (int k = 0; k < cnt; ++k) {
      const int w0 = __shfl_sync(0xffffffffu, mine.x, k);
      const int w1 = __shfl_sync(0xffffffffu, mine.y, k);
      const int pa = w0 & 127, pe = (w0 >> 7) & 255;
      const int end = (w0 >> 15) & 1, near = (w0 >> 16) & 1;
      const int srcl = (pa - ((w0 >> 17) & 255)) & 255;
      const int m = pe - pa;
      const long long dst = b * 128 + pa;
      long long src;
      bool from_lit = false;
      if (near) {
        src = dst - (128 + pa - srcl);
      } else if (w1 >= nout) {
        src = (long long)w1 * 128 + srcl - nout * 128;
        from_lit = true;
      } else {
        src = (long long)w1 * 128 + srcl;
      }
      uint8_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = q * 32 + lane;
        v[q] = 0;
        if (j < m) {
          long long s = src + j;
          if (from_lit) {
            s = s < 0 ? 0 : (s >= L ? L - 1 : s);
            v[q] = L > 0 ? l[s] : 0;
          } else {
            s = s < 0 ? 0 : (s >= S_max ? S_max - 1 : s);
            v[q] = o[s];
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = q * 32 + lane;
        const long long d = dst + j;
        if (j < m && d >= 0 && d < S_max) o[d] = v[q];
      }
      __syncwarp();
      b += end;
    }
  }
  int ol = out_len[c];
  ol = ol < 0 ? 0 : (ol > S_max ? S_max : ol);
  for (int j = ol + lane; j < S_max; j += 32) o[j] = 0;
}

}  // namespace

extern "C" int hap_exec_tables(const void* ops, int nops, const void* n_ops,
                               const void* lit, int L, const void* out_len,
                               void* out, int S_max, int C, void* stream) {
  if (C > 0)
    exec_tables_kernel<<<(C + kWarps - 1) / kWarps, 32 * kWarps, 0,
                         (cudaStream_t)stream>>>(
        (const int2*)ops, nops, (const int32_t*)n_ops, (const uint8_t*)lit, L,
        (const int32_t*)out_len, (uint8_t*)out, S_max, C);
  return (int)cudaGetLastError();
}
