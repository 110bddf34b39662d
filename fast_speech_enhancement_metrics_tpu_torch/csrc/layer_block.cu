// One whole post-LN HuBERT encoder layer in one launch.
//
// Replaces the Pallas TPU kernel ops/attn_block_pallas.py::_layer_block_kernel
// of the JAX package (A11, layer_block): A7's attention block, then A8's FFN
// block, with x crossing from one to the other in x's dtype:
//   h = LN1(x + W_o attn(x W_qkv + b_qkv) + b_o),
//   y = LN2(h + W_2 gelu_tanh(h W_1 + b_1) + b_2),
// with A7's and A8's roundings (attn_block.cu).
//
// What bounds it on this card: operations, A7's plus A8's: about 0.85 TFLOP
// of bf16 tensor-core work per launch at mHuBERT-147's width and 64 rows of
// 799 frames (0.86 ms at 989 TFLOP/s).
//
// Design: a persistent kernel on a co-resident grid (cooperative launch,
// sized by the occupancy calculator), 256 threads a block. Its phases, each
// ended by a grid-wide barrier, run the tile routines that A7 and A8 launch
// one by one (block_tiles.cuh, attention_core.cuh), in the same order on the
// same operands, so the result is theirs bit for bit:
//   1. QKV GEMM tiles (x -> qkv, bf16)
//   2. attention items (row, head, 64 queries): each half of a block runs
//      one item with its own named barrier and its own shared memory
//   3. W_o GEMM tiles (ctx -> y, fp32)
//   4. residual + LN1 rows (y, x -> h, x's dtype)
//   5. W_1 GEMM tiles + tanh GELU (h -> hidden, bf16)
//   6. W_2 GEMM tiles (hidden -> y, fp32)
//   7. residual + LN2 rows (y, h -> out, x's dtype)
// Dynamic shared memory is the largest phase's (two attention items). The
// scratch (qkv, ctx, y, h, hidden) stays in device memory, as between A7's
// and A8's launches: the TPU kernel held it in VMEM, which this card does
// not have at that size. What one launch saves is the launches and their
// tails; each phase still waits for its slowest tile.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "attention_core.cuh"
#include "block_tiles.cuh"
#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using namespace tiles;

struct LayerArgs {
  const void* x;
  const bf16 *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *ln1s, *ln1b, *b1, *b2, *ln2s, *ln2b;
  bf16 *qkv, *ctx, *hidden;
  float* y;
  void* h;
  void* out;
  int rows, t_len, d, heads, ffn;
  float eps;
};

template <typename TA, int kEpi, typename TC>
__device__ __forceinline__ void gemm_phase(const TA* A, const bf16* B, const float* bias, TC* C,
                                           int M, int N, int K, unsigned char* smem) {
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem);
  const int n_tiles = (N + kBN - 1) / kBN, m_tiles = (M + kBM - 1) / kBM;
  for (int tile = blockIdx.x; tile < m_tiles * n_tiles; tile += gridDim.x) {
    gemm_tile<TA, kEpi, TC>(A, B, bias, C, M, N, K, tile / n_tiles, tile % n_tiles, sm, threadIdx.x);
  }
}

template <typename TX>
__device__ __forceinline__ void ln_phase(const float* y, const TX* x, const float* s, const float* b,
                                         TX* out, int M, int n, float eps) {
  constexpr int kWarps = kGemmThreads / 32;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M; m += gridDim.x * kWarps) {
    residual_ln_row<TX>(y, x, s, b, out, m, n, eps, threadIdx.x & 31);
  }
}

template <int HDP, int kMode>
__host__ __device__ constexpr size_t attention_smem() {
  return (attn::Shape<bf16, HDP, kMode>::kSmem + 127) / 128 * 128;
}

template <int HDP, int kMode>
__host__ __device__ constexpr size_t layer_smem() {
  return 2 * attention_smem<HDP, kMode>() > sizeof(GemmSmem) ? 2 * attention_smem<HDP, kMode>()
                                                              : sizeof(GemmSmem);
}

template <typename TX, int HDP, int kMode>
__global__ void __launch_bounds__(kGemmThreads) layer_kernel(LayerArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const TX* x = static_cast<const TX*>(p.x);
  TX* h = static_cast<TX*>(p.h);
  const int M = p.rows * p.t_len, d = p.d;

  gemm_phase<TX, kBiasBf16, bf16>(x, p.wqkv, p.bqkv, p.qkv, M, 3 * d, d, smem);
  grid.sync();

  {  // attention: item = (query tile, head, row), query tiles fastest as A7's grid
    const attn::Args a = attn::qkv_args(p.qkv, p.ctx, p.t_len, d, p.heads);
    const int half = threadIdx.x / attn::kThreads;
    const int q_tiles = (p.t_len + attn::kQTile - 1) / attn::kQTile;
    const int n_items = q_tiles * p.heads * p.rows;
    unsigned char* base = smem + half * attention_smem<HDP, kMode>();
    const attn::NamedSync sync{1 + half};
    for (int item = 2 * blockIdx.x + half; item < n_items; item += 2 * gridDim.x) {
      sync();  // the previous item's warps are done with its Q tile
      attn::attention_tile<bf16, HDP, kMode>(a, item % q_tiles, (item / q_tiles) % p.heads,
                                             item / (q_tiles * p.heads), base,
                                             threadIdx.x % attn::kThreads, sync);
    }
  }
  grid.sync();

  gemm_phase<bf16, kBiasF32, float>(p.ctx, p.wo, p.bo, p.y, M, d, d, smem);
  grid.sync();
  ln_phase<TX>(p.y, x, p.ln1s, p.ln1b, h, M, d, p.eps);
  grid.sync();
  gemm_phase<TX, kBiasGeluBf16, bf16>(h, p.w1, p.b1, p.hidden, M, p.ffn, d, smem);
  grid.sync();
  gemm_phase<bf16, kBiasF32, float>(p.hidden, p.w2, p.b2, p.y, M, d, p.ffn, smem);
  grid.sync();
  ln_phase<TX>(p.y, h, p.ln2s, p.ln2b, static_cast<TX*>(p.out), M, d, p.eps);
}

template <typename TX, int HDP, int kMode>
int launch_layer(LayerArgs& p, cudaStream_t stream) {
  auto kernel = layer_kernel<TX, HDP, kMode>;
  constexpr size_t smem = layer_smem<HDP, kMode>();
  static_assert(smem <= 232448, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGemmThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(per_sm * sms),
                                    dim3(kGemmThreads), args, smem, stream);
  return (int)err;
}

template <typename TX, int HDP>
int launch_mode(LayerArgs& p, int mode, cudaStream_t stream) {
  switch (mode) {
    case attn::kExp2: return launch_layer<TX, HDP, attn::kExp2>(p, stream);
    case attn::kExp2Bf16: return launch_layer<TX, HDP, attn::kExp2Bf16>(p, stream);
    case attn::kExact: return launch_layer<TX, HDP, attn::kExact>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TX>
int launch_width(LayerArgs& p, int mode, cudaStream_t stream) {
  switch (p.d / p.heads) {  // heads of 64 (HuBERT base, large) and 80 (xlarge)
    case 64: return launch_mode<TX, 64>(p, mode, stream);
    case 80: return launch_mode<TX, 80>(p, mode, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// A11. x, out, scratch h: (rows, t_len, d), all fp32 or all bf16 (x_bf16);
// wqkv, bqkv, wo, bo, ln1 scale / shift as A7's (attn_block.cu); w1, b1, w2,
// b2, ln2 scale / shift as A8's; scratch qkv (rows t_len, 3 d) bf16, ctx
// (rows t_len, d) bf16, y (rows t_len, d) fp32, hidden (rows t_len, ffn)
// bf16. d % 32 == 0, ffn % 32 == 0, d / heads 64 or 80; mode 0 exp2,
// 1 exp2_bf16, 2 exact; tanh GELU.
extern "C" int fsem_layer_block(const void* x, const void* wqkv, const float* bqkv, const void* wo,
                                const float* bo, const float* ln1s, const float* ln1b, const void* w1,
                                const float* b1, const void* w2, const float* b2, const float* ln2s,
                                const float* ln2b, void* qkv, void* ctx, float* y, void* h,
                                void* hidden, void* out, int rows, int t_len, int d, int heads,
                                int ffn, int mode, int x_bf16, float eps, void* stream_ptr) {
  if (heads <= 0 || d % heads || d % kBK || ffn % kBK) return (int)cudaErrorInvalidValue;
  LayerArgs p{};
  p.x = x;
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.wo = static_cast<const bf16*>(wo);
  p.w1 = static_cast<const bf16*>(w1);
  p.w2 = static_cast<const bf16*>(w2);
  p.bqkv = bqkv;
  p.bo = bo;
  p.ln1s = ln1s;
  p.ln1b = ln1b;
  p.b1 = b1;
  p.b2 = b2;
  p.ln2s = ln2s;
  p.ln2b = ln2b;
  p.qkv = static_cast<bf16*>(qkv);
  p.ctx = static_cast<bf16*>(ctx);
  p.hidden = static_cast<bf16*>(hidden);
  p.y = y;
  p.h = h;
  p.out = out;
  p.rows = rows;
  p.t_len = t_len;
  p.d = d;
  p.heads = heads;
  p.ffn = ffn;
  p.eps = eps;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return x_bf16 ? launch_width<bf16>(p, mode, stream) : launch_width<float>(p, mode, stream);
}
