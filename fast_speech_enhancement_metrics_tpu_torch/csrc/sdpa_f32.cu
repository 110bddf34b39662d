// Long-audio attention in float32: the precision="highest" arm of A9 and
// A15 (see sdpa.cu for what they replace and compute).
//
// What bounds it on this card: operations, here float32 FMAs outside the
// tensor cores (67 TFLOP/s; never TF32): 0.44 TFLOP at 16 x 12 x 2999 x 64
// is 6.6 ms at best.
//
// Design: attention_core.cuh (SIMT, float32 throughout): per warp 16
// queries, each lane one query row and half of the key columns for q k^T
// and half of the head's columns for p v, the accumulator in shared
// memory; K and V take turns in one shared tile so a head of 128 fits.
// Kept in its own source so that nvcc builds it beside sdpa.cu.
#include "attention_core.cuh"

// as fsem_sdpa, with q, k, v, o float32
extern "C" int fsem_sdpa_f32(const void* q, const void* k, const void* v, void* o, int batch,
                             int heads, int t_len, int n_keys, int head_dim, int mode,
                             float scale, float l_pad, void* stream_ptr) {
  if (head_dim <= 0 || head_dim > attn::kMaxHead || t_len <= 0 || n_keys < t_len)
    return (int)cudaErrorInvalidValue;
  const attn::Args a = attn::bhtd_args(q, k, v, o, heads, t_len, n_keys, head_dim, scale, l_pad);
  return (int)attn::launch_mode(a, mode, heads, batch, static_cast<cudaStream_t>(stream_ptr));
}
