// WavLM's pre-LN encoder layer with the gated relative-position bias, bf16
// operands with fp32 accumulation.
//
// Replaces no TPU kernel: the JAX package has no WavLM. Added for
// SpeechBERTScore on WavLM-Large (ops/relpos_attention.py), whose every
// layer adds to each attention logit layer 0's position bias gated per
// query: s[i, j] = (q_i s_q) k_j + g_i B_h(j - i). A plain version builds
// that bias whole, rows x heads x T^2 floats a layer (2.6 GB for 64 rows of
// 799 frames at 16 heads); the kernel forms it in registers.
//
// Three entry points a layer, launched in turn (the middle one alone is the
// attention, which the port's span fsem.hubert.relpos_attn times):
// * fsem_prenorm_in: u = bf16(LN1(x)), then [q | k | v | gate logits] =
//   bf16(u W_qkvg + b) on gemm_sm90.cuh's product (the attention scale,
//   and log2 e in the exp2 modes, folded into the q columns, the gate's
//   groups of 4 folded into two columns a head);
// * fsem_relpos_attention: flash_sm90.cuh's body with the bias branch
//   (relpos_attn_kernel): per thread and key tile 34 floats of the head's
//   offset vector (o0 + 8 m + b), loaded while S = Q K^T is multiplied, and
//   the two gates of its query rows, from the product's gate columns once;
//   s += g B before the softmax, in the exact mode's max pass too;
// * fsem_prenorm_out: W_o's product in fp32, x1 = x + it and u = bf16(LN2(x1))
//   in one pass, W_1's product with the tanh GELU, W_2's in fp32, out = x1 +
//   it.
// The residual stream stays fp32; LayerNorm statistics, the gate and the
// softmax are fp32.
//
// What bounds it on this card: operations. At WavLM-Large's width (d 1024,
// 16 heads of 64, FFN 4096) and 64 rows of 799 frames one layer is 1.45
// TFLOP of bf16 products (1.47 ms at 989 TFLOP/s), the attention 0.167 of
// it (0.17 ms); the LayerNorm and residual passes move ~1.3 GB (0.4 ms).
#include <cuda_bf16.h>

#include "block_tiles.cuh"
#include "flash_sm90.cuh"

extern "C" int fsem_gemm(const void* a, const void* b, const float* bias, void* c, int M, int N, int K, int epi,
                         void* stream_ptr);

namespace {

using bf16 = __nv_bfloat16;
constexpr int kEpiBf16 = 0, kEpiGeluBf16 = 1, kEpiF32 = 2;  // gemm_sm90.cuh's bf16 epilogues

// One warp a row of n <= 32 kPer columns, lane l taking l, l + 32, ...:
// r = x (+ y with kAdd, written to sum in fp32; sum may be x), then with
// kNorm out = bf16((r - mean) rsqrt(var + eps) s + b), mean and centered
// variance in fp32.
template <bool kAdd, bool kNorm>
__global__ void __launch_bounds__(tiles::kLnWarps * 32)
    add_ln_kernel(const float* x, const float* __restrict__ y, const float* __restrict__ scale,
                  const float* __restrict__ shift, float* sum, bf16* __restrict__ out, int M, int n, float eps) {
  const int m = blockIdx.x * tiles::kLnWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const int lane = threadIdx.x & 31;
  const size_t at = (size_t)m * n;
  float r[tiles::kPer];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < tiles::kPer; ++i) {
    const int c = lane + 32 * i;
    r[i] = c < n ? (kAdd ? x[at + c] + y[at + c] : x[at + c]) : 0.f;
    acc += r[i];
  }
  if constexpr (kAdd) {
#pragma unroll
    for (int i = 0; i < tiles::kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < n) sum[at + c] = r[i];
    }
  }
  if constexpr (kNorm) {
    const float mean = fsem::warp_sum(acc) / (float)n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < tiles::kPer; ++i) {
      if (lane + 32 * i < n) sq = fmaf(r[i] - mean, r[i] - mean, sq);
    }
    const float inv = rsqrtf(fsem::warp_sum(sq) / (float)n + eps);
#pragma unroll
    for (int i = 0; i < tiles::kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < n) out[at + c] = __float2bfloat16((r[i] - mean) * inv * scale[c] + shift[c]);
    }
  }
}

template <bool kAdd, bool kNorm>
cudaError_t add_ln(const float* x, const float* y, const float* s, const float* b, float* sum, bf16* out, int M,
                   int n, float eps, cudaStream_t stream) {
  add_ln_kernel<kAdd, kNorm><<<(M + tiles::kLnWarps - 1) / tiles::kLnWarps, tiles::kLnWarps * 32, 0, stream>>>(
      x, y, s, b, sum, out, M, n, eps);
  return cudaGetLastError();
}

bool row_fits(int M, int d) { return M > 0 && d > 0 && d % 32 == 0 && d <= 32 * tiles::kPer; }

}  // namespace

// qkvg: (rows, t_len, n) bf16, columns [q | k | v | gate logits, two a
// head] (q pre-scaled); gate_const (heads,) fp32; offsets (heads, 2 tp) fp32,
// tp >= t_len rounded up to 128 (ops/relpos_attention.py::offset_bias); ctx
// (rows, t_len, d) bf16. d / heads a multiple of 8, at most 128; n % 8 == 0
// and n >= 3 d + 2 heads; mode 0 exp2, 1 exp2_bf16, 2 exact.
extern "C" int fsem_relpos_attention(const void* qkvg, const float* gate_const, const float* offsets, void* ctx,
                                     int rows, int t_len, int d, int heads, int n, int tp, int mode,
                                     void* stream_ptr) {
  if (rows <= 0 || t_len <= 0 || heads <= 0 || d % heads) return (int)cudaErrorInvalidValue;
  const int hd = d / heads;
  const int t_pad = (t_len + flash90::kBlockK - 1) / flash90::kBlockK * flash90::kBlockK;
  if (hd % 8 || hd > flash90::kMaxHead || mode < 0 || mode > 2 || n % 8 || n < 3 * d + 2 * heads || tp < t_pad ||
      (long long)t_len * d > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bf16* base = static_cast<const bf16*>(qkvg);
  const long long row_stride = (long long)t_len * n;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    if (!flash90::view_map(&maps[i], flash90::View{base + i * d, n, hd, row_stride}, rows, heads, t_len, hd))
      return (int)cudaErrorInvalidValue;
  }
  const flash90::View out{ctx, d, hd, (long long)t_len * d};
  const flash90::RelPos rel{base + 3 * d, n, row_stride, gate_const, offsets, tp};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (hd <= sm90::kBoxCols)
    return (int)flash90::launch_rel_mode<1>(maps[0], maps[1], maps[2], out, rows, heads, t_len, hd, mode, rel,
                                            stream);
  return (int)flash90::launch_rel_mode<2>(maps[0], maps[1], maps[2], out, rows, heads, t_len, hd, mode, rel, stream);
}

// x (M, d) fp32; ln1 scale / shift (d,) fp32; wqkvg (d, n) bf16; bqkvg (n,)
// fp32; scratch u (M, d) bf16; qkvg (M, n) bf16 out. d % 32 == 0, d <= 1280,
// n % 8 == 0.
extern "C" int fsem_prenorm_in(const float* x, const float* ln1s, const float* ln1b, const void* wqkvg,
                               const float* bqkvg, void* u, void* qkvg, int M, int d, int n, float eps,
                               void* stream_ptr) {
  if (!row_fits(M, d) || n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      add_ln<false, true>(x, nullptr, ln1s, ln1b, nullptr, static_cast<bf16*>(u), M, d, eps, stream);
  if (err != cudaSuccess) return (int)err;
  return fsem_gemm(u, wqkvg, bqkvg, qkvg, M, n, d, kEpiBf16, stream_ptr);
}

// x (M, d) fp32, ctx (M, d) bf16; wo (d, d), w1 (d, ffn), w2 (ffn, d) bf16;
// bo, b1, b2, ln2 scale / shift fp32; scratch y (M, d) fp32, u (M, d) bf16,
// hidden (M, ffn) bf16; out (M, d) fp32 = x1 + W_2 gelu_tanh(LN2(x1) W_1 +
// b_1) + b_2, x1 = x + ctx W_o + b_o. d % 32 == 0, d <= 1280, ffn % 8 == 0.
extern "C" int fsem_prenorm_out(const float* x, const void* ctx, const void* wo, const float* bo, const float* ln2s,
                                const float* ln2b, const void* w1, const float* b1, const void* w2, const float* b2,
                                float* y, void* u, void* hidden, float* out, int M, int d, int ffn, float eps,
                                void* stream_ptr) {
  if (!row_fits(M, d) || ffn <= 0 || ffn % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int err = fsem_gemm(ctx, wo, bo, y, M, d, d, kEpiF32, stream_ptr);
  if (err != 0) return err;
  err = (int)add_ln<true, true>(x, y, ln2s, ln2b, out, static_cast<bf16*>(u), M, d, eps, stream);
  if (err != 0) return err;
  err = fsem_gemm(u, w1, b1, hidden, M, ffn, d, kEpiGeluBf16, stream_ptr);
  if (err != 0) return err;
  err = fsem_gemm(hidden, w2, b2, y, M, d, ffn, kEpiF32, stream_ptr);
  if (err != 0) return err;
  return (int)add_ln<true, false>(out, y, nullptr, nullptr, out, nullptr, M, d, eps, stream);
}
