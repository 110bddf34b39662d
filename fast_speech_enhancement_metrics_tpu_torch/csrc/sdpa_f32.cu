// Long-audio attention in float32: the precision="highest" arm of A9 and
// A15 (see sdpa.cu for what they replace and compute).
//
// What bounds it on this card: operations. On the TPU "highest" means
// bf16x6 MXU passes; here the same six bf16 products of order <= 2 run on
// the bf16 tensor cores, 6 x 4 T^2 D per (row, head) (kExact: 6 x 6 T^2 D
// with its max pass): at 16 x 12 x 2999 x 64, 2.68 ms at 989 TFLOP/s
// (4.02 ms with the max pass), and 62.7 ms at A15's 2 x 12 x 40 999 x 64.
// The split pass moves 4 bytes in and 6 D_p / hd out per element of q, k
// and v.
//
// Design: two launches. The split pass (sdr_halves.cuh,
// halves::split_rows<3>) writes the three bf16 pieces of q (already
// scaled), k and v, each head zero-padded to D_p = 64 or 128 columns; the
// attention kernel (flash_f32_sm90.cuh) reads them through TMA, multiplies
// on wgmma and keeps the softmax and O in registers.
#include "flash_f32_sm90.cuh"

// q, k, v (rows, head_dim) float32 with rows = batch x heads x t_len,
// contiguous, 16-byte aligned; pieces (3 tensors, 3 pieces, rows, d_p)
// bf16, 16-byte aligned, d_p 64 (head_dim <= 64) or 128
extern "C" int fsem_sdpa_f32_split(const float* q, const float* k, const float* v, void* pieces, long long rows,
                                   int head_dim, int d_p, void* stream_ptr) {
  if (d_p != (head_dim <= sm90::kBoxCols ? sm90::kBoxCols : 2 * sm90::kBoxCols) || head_dim > flash32::kMaxHead)
    return (int)cudaErrorInvalidValue;
  return (int)halves::split_rows<flash32::kPieces>(q, k, v, pieces, rows, head_dim, d_p,
                                                   static_cast<cudaStream_t>(stream_ptr));
}

// pieces as fsem_sdpa_f32_split writes them for (batch, heads, t_len,
// head_dim); o (batch, heads, t_len, head_dim) float32, contiguous. n_keys:
// the keys the reference walks (t_len; A15: t_len padded to 512); the
// kernel skips key tiles wholly past t_len, which add nothing. mode: 0
// exp2, 1 exp2_bf16, 2 exact, 3 online (A15). scale multiplies the logits
// in mode 3; l_pad is added to each row sum in modes 0-2.
extern "C" int fsem_sdpa_f32(const void* pieces, float* o, int batch, int heads, int t_len, int n_keys, int head_dim,
                             int mode, float scale, float l_pad, void* stream_ptr) {
  if (head_dim <= 0 || head_dim > flash32::kMaxHead || t_len <= 0 || n_keys < t_len || batch <= 0 ||
      batch > 65535 || heads <= 0 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const int d_p = head_dim <= sm90::kBoxCols ? sm90::kBoxCols : 2 * sm90::kBoxCols;
  const unsigned long long rows = (unsigned long long)batch * heads;
  const unsigned long long plane = rows * t_len * d_p * 2;  // bytes of one piece of one tensor
  CUtensorMap maps[3];
  for (int x = 0; x < 3; ++x) {  // q, k, v: (d_p, t_len, rows, piece); Q in boxes of 128 rows, K and V of 64
    const cuuint64_t dims[4] = {(cuuint64_t)d_p, (cuuint64_t)t_len, (cuuint64_t)rows, (cuuint64_t)flash32::kPieces};
    const cuuint64_t strides[3] = {(cuuint64_t)d_p * 2, (cuuint64_t)t_len * d_p * 2, (cuuint64_t)plane};
    const void* ptr = static_cast<const uint8_t*>(pieces) + x * flash32::kPieces * plane;
    if (!sm90::tensor_map(&maps[x], ptr, 4, dims, strides, x == 0 ? flash32::kBlockQ : flash32::kBlockK))
      return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (d_p == sm90::kBoxCols)
    return (int)flash32::launch_mode<1>(maps, o, batch, heads, t_len, head_dim, mode, scale, l_pad, stream);
  return (int)flash32::launch_mode<2>(maps, o, batch, heads, t_len, head_dim, mode, scale, l_pad, stream);
}
