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
// Design: attention_core.cuh's bf16 arm with its own (B H, T, D) layout.
// The TPU kernel holds a head's K/V in VMEM; an SM holds 227 KB, so K/V
// tiles of 64 keys (128 for A15) stream through shared memory, and A15
// keeps its normalised accumulator in shared memory between tiles. A first,
// simple version: wmma (mma.sync) 16x16x16 fragments, no wgmma or TMA yet.
#include "attention_core.cuh"

// q, k, v, o: (batch, heads, t_len, head_dim) bf16, contiguous; head_dim <=
// 128. n_keys: keys walked (t_len; A15: t_len padded to 512). mode: 0 exp2,
// 1 exp2_bf16, 2 exact, 3 online (A15). scale multiplies the logits in mode
// 3; l_pad is added to each row sum in modes 0-2.
extern "C" int fsem_sdpa(const void* q, const void* k, const void* v, void* o, int batch,
                         int heads, int t_len, int n_keys, int head_dim, int mode, float scale,
                         float l_pad, void* stream_ptr) {
  if (head_dim <= 0 || head_dim > attn::kMaxHead || t_len <= 0 || n_keys < t_len)
    return (int)cudaErrorInvalidValue;
  const attn::Args a = attn::bhtd_args(q, k, v, o, heads, t_len, n_keys, head_dim, scale, l_pad, 2);
  return (int)attn::launch_mode<__nv_bfloat16>(a, mode, heads, batch,
                                               static_cast<cudaStream_t>(stream_ptr));
}
