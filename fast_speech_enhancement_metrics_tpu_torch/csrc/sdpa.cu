// Long-audio attention, bf16 operands with fp32 accumulation.
//
// Replaces two TPU kernels of the JAX package:
//   A9  ops/sdpa_pallas.py::_sdpa_kernel (sdpa): softmax(q k^T) v with one
//       head's whole K/V resident in VMEM, softmax exp2 / exp2_bf16 / exact;
//   A15 the upstream jax.experimental.pallas.ops.tpu.flash_attention kernel
//       that models/hubert.py::_flash_sdpa calls past 40 000 frames: the
//       exact online softmax over key blocks of 128.
// The scale of A9 is applied to q before the call, in q's dtype, as the JAX
// wrapper does (ops/sdpa_pallas.py:105-107); A15 multiplies the fp32 logits
// by its scale inside the kernel, as the upstream kernel does.
//
// What bounds it on this card: operations. At SpeechBERTScore's long-clip
// shape (16 rows x 12 heads x 2999 frames x 64) one launch is 2 x 2 x T^2 x
// 64 x 192 = 0.44 TFLOP of bf16 tensor-core work (0.45 ms at 989 TFLOP/s)
// against 0.09 GB of q, k, v and o (0.03 ms); "exact" computes q k^T twice
// (its max pass). A15 at 2 x 12 x 40 999 frames is 10.3 TFLOP (10.4 ms).
//
// Design: flash_sm90.cuh, a Hopper kernel (TMA loads in a ring of stages
// fed by a producer warp, wgmma products, the softmax in registers) with
// the (B, H, T, D) layout read through 4-D TMA tensor maps; A7's attention
// (attn_block.cu) launches the same instantiations on its strided qkv. The
// TPU kernel holds a head's K/V in VMEM; here K/V tiles of 128 keys stream
// through shared memory. The float32 arm (sdpa_f32.cu, flash_f32_sm90.cuh)
// runs this block shape on bf16x6 products.
#include "flash_sm90.cuh"

int fsem_flash_attention(const void* q, const void* k, const void* v, long long ld, long long head_stride,
                         long long row_stride, void* o, long long o_ld, long long o_head_stride,
                         long long o_row_stride, int rows, int heads, int t_len, int hd, int mode, float scale,
                         float l_pad, cudaStream_t stream) {
  // the kernel indexes a (row, head)'s output frames in 32 bits
  if (hd <= 0 || hd > flash90::kMaxHead || hd % 8 != 0 || t_len <= 0 || rows <= 0 || heads <= 0 ||
      (long long)t_len * o_ld > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (!flash90::view_map(&maps[i], flash90::View{ptrs[i], ld, head_stride, row_stride}, rows, heads, t_len, hd))
      return (int)cudaErrorInvalidValue;
  }
  const flash90::View out{o, o_ld, o_head_stride, o_row_stride};
  if (hd <= sm90::kBoxCols)
    return (int)flash90::launch_mode<1>(maps[0], maps[1], maps[2], out, rows, heads, t_len, hd, mode, scale, l_pad,
                                        stream);
  return (int)flash90::launch_mode<2>(maps[0], maps[1], maps[2], out, rows, heads, t_len, hd, mode, scale, l_pad,
                                      stream);
}

// q, k, v, o: (batch, heads, t_len, head_dim) bf16, contiguous, 16-byte
// aligned; head_dim a multiple of 8, at most 128. n_keys: the keys the
// reference walks (t_len; A15: t_len padded to 512); the kernel skips key
// tiles wholly past t_len, which add nothing. mode: 0 exp2, 1 exp2_bf16,
// 2 exact, 3 online (A15). scale multiplies the logits in mode 3; l_pad is
// added to each row sum in modes 0-2.
extern "C" int fsem_sdpa(const void* q, const void* k, const void* v, void* o, int batch,
                         int heads, int t_len, int n_keys, int head_dim, int mode, float scale,
                         float l_pad, void* stream_ptr) {
  if (n_keys < t_len) return (int)cudaErrorInvalidValue;
  const long long ld = head_dim, head_stride = (long long)t_len * head_dim, row_stride = heads * head_stride;
  return fsem_flash_attention(q, k, v, ld, head_stride, row_stride, o, ld, head_stride, row_stride, batch, heads,
                              t_len, head_dim, mode, scale, l_pad, static_cast<cudaStream_t>(stream_ptr));
}
