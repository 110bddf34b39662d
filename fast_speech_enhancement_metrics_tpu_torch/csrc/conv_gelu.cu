// HuBERT's conv feature encoder, convs 1-6: out = gelu(conv1d(x, w, stride 2))
// in float32 on the bf16 tensor cores, the GELU in the epilogue; in the
// layer-norm encoder (WavLM) out = gelu(LN_channels(conv1d(x, w, stride 2))),
// the LayerNorm in the epilogue too. Conv 0 of the layer-norm encoder, whose
// shape the tensor-core kernel does not take, is a direct float32 kernel with
// the same epilogue (conv0_ln_gelu_kernel, at the end).
//
// Replaces no Pallas kernel: the JAX package leaves these convs to XLA
// (models/hubert.py::feature_encoder, lax.conv_general_dilated at
// "highest", which the TPU runs as bf16x6 MXU passes). On the card they
// ran on cuDNN's float32 implicit GEMM on the CUDA cores (TF32 would miss
// the encoder's float32 class), at 65 % of that 67 TFLOP/s peak.
//
// As a GEMM per row b: D (frames, C_out) = A (frames, k C_in) B (k C_in,
// C_out), A[t, (j, c)] = x[b, c, 2 t + j], B[(j, c), o] = w[o, c, j]. At
// mHuBERT-147's widths (C 512, k 3 3 3 3 2 2) and 64 rows of 16 s, convs
// 1-6 are 4.99 TFLOP a launch set. What bounds it on this card:
// operations, six bf16 products per float32 product on the tensor cores
// (989 / 6 TFLOP/s), against about 4 bytes read and 2 written per input
// sample and channel.
//
// Precision: bf16x6, the float32 class of flash_f32_sm90.cuh. w arrives as
// three bf16 pieces, w = w0 + w1 + w2, split once per layer by the wrapper
// (ops/conv_gelu.py::split_pieces); x is split inside the kernel, in
// registers, the same way (each difference exact in float32). A product is
// the six piece products of order <= 2, x-piece by w-piece (1,1), (0,2),
// (2,0), (0,1), (1,0), (0,0), each exact in the tensor cores. The tensor
// cores round each accumulation at the magnitude of the running sum (on
// the card one sum over all 512 channels read 8x cuDNN's float32 error),
// so each step of 16 channels forms a partial of its own, every tap's
// small products first and the main ones last, and adds it to the tile's
// sum in float32: 0.15-0.6x cuDNN's error from a float64 reference.
//
// Design. A persistent grid of one block per SM walks tiles of 128 frames
// x 128 output channels of one row, channels fastest (the four channel
// tiles of a frame tile read its samples from L2 together). 384 threads:
//   producer warpgroup (24 registers after setmaxnreg): per stage of 32
//     input channels, one warp loads the weight pieces by TMA (every tap
//     and piece: boxes of 32 channels x 128 outputs, K-major, 64-byte
//     swizzle) and the samples of the 32 channel rows, a row a lane, each
//     one bulk copy of 16-byte-aligned runs from the boundary at or before
//     the tile's first sample (a row of x starts at any 4-byte offset, so
//     TMA's 16-byte strides do not fit; the row then sits (c T_in) & 3
//     floats into its row of the tile); all complete on the stage's full
//     mbarrier. Samples past T_in are not copied, and frames that would
//     read them are not stored. (Copies of 4 bytes by all 128 threads kept
//     the consumers waiting a third of their time; a clock inside the
//     kernel showed it.)
//   two consumer warpgroups (240 registers), 64 frames each: per step of
//     16 channels a thread holds its 2 frames x 4 channels x k samples of
//     the tile (read while the step before multiplies), splits x[c, 2 t +
//     j] of every tap j into the three A fragments of wgmma m64n128k16
//     (register A: the taps are strided views of the tile, so no sample is
//     stored twice) and issues the 6 k products against the taps' weight
//     pieces (B from shared memory, K-major). A warpgroup waits for its
//     step's products before it adds the partial; the other warpgroup's
//     products fill the tensor cores meanwhile.
// Epilogue: gelu (erf or tanh, fp32) from registers straight to out
// (B, C_out, T_out): a warp's store covers 8 frames of 4 channels, whole
// 32-byte runs. Frames at or past T_out and channels at or past C_out are
// not stored.
//
// The layer-norm epilogue (kNorm = kLayer): a frame's C_out channels lie in
// C_out / 128 blocks, so those blocks run as one thread block cluster, each
// on the channel tile of its rank, the cluster walking frame tiles (the
// grid a whole number of clusters; the tile order is the one above). Per
// frame, numerics.layer_norm's two-pass float32 statistics, the mean first,
// then the centred squares: the thread's 32 channels, then its quad by
// shuffles (a frame's 128 channels of the block are one quad's), then the
// cluster: each quad's first thread stores the block's partial into slot
// (rank, quad) of every block of the cluster (distributed shared memory by
// st.async, whose bytes count on the receiving block's mbarrier as a TMA
// copy's: a release-ordered remote arrival waited for the thread's output
// stores of the tile before, and cost 6 % of conv 1's time); each block
// adds the C_out / 128 partials in rank order, so every block finds the
// same statistics, and the same from every launch. Then (v - mean)
// rsqrt(var + eps) scale + shift and the GELU, stored as above. Frames at
// or past T_out have statistics of their own and are not stored. A block
// reads only its own shared memory, and receives a tile's partials before
// it ends the tile, so none is written after it exits.
//
// Shared memory: two stages of the float32 tile (32 x 264 x 4 = 33 KB) and
// the weight pieces (k x 3 x 8 KB), 210 KB at k = 3; the layer-norm
// epilogue's partials 8 KB more.
#include "sm90.cuh"

namespace {
namespace convg {

using namespace sm90;

constexpr int kBT = 128;   // frames a tile: two consumer warpgroups of 64
constexpr int kBO = 128;   // output channels a tile: wgmma's N
constexpr int kKC = 32;    // input channels a stage: one 64-byte row of bf16
constexpr int kPieces = 3;
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65 536
// floats a channel row of the tile: a row's copy spans at most 260 (257
// samples after up to 3 floats before them, rounded up to 4), and 1056
// bytes keep each row 16-byte aligned
constexpr int kPitch = 264;
enum Gelu { kErf = 0, kTanh = 1 };
enum Norm { kNone = 0, kLayer = 1 };
constexpr int kMaxCluster = 8;  // the layer-norm epilogue's blocks a frame: C_out <= 8 x 128
constexpr int kQuads = kConsumers * 128 / 4;  // the consumers' quads: one a frame pair of the tile

template <int kWidth, int kNorm>
struct Layout {
  static constexpr int kSamples = 2 * (kBT - 1) + kWidth;  // samples a tile's frames read
  static constexpr int kAct = kKC * kPitch * 4;
  static constexpr int kWBox = kBO * 64;  // one tap and piece: 128 outputs x 64 bytes
  static constexpr int kStage = kAct + kWidth * kPieces * kWBox;
  static constexpr int kStages = 2;
  static constexpr int kBarOff = kStages * kStage;
  // full and empty a stage; the layer-norm epilogue's mean and variance barriers
  static constexpr int kBars = 2 * kStages + (kNorm == kLayer ? 2 : 0);
  static constexpr int kStatOff = kBarOff + 8 * kBars;
  // the partials of the mean and of the variance: (rank, quad) x two frames
  static constexpr int kStatBytes = kNorm == kLayer ? 2 * kMaxCluster * kQuads * 8 : 0;
  static constexpr size_t kBytes = kStatOff + kStatBytes + 1024;  // + slack to align the base to 1024
  static_assert(kSamples <= kPitch && kAct % 1024 == 0 && kStage % 1024 == 0 && kStatOff % 16 == 0, "tile layout");
  static_assert(kBytes <= 232448, "shared memory");
};

// the pieces of the x-factor and of the w-factor of product t: (1,1),
// (0,2), (2,0), (0,1), (1,0), (0,0)
__host__ __device__ constexpr int piece_x(int t) { return t == 0 || t == 4 ? 1 : (t == 2 ? 2 : 0); }
__host__ __device__ constexpr int piece_w(int t) { return t == 0 || t == 3 ? 1 : (t == 1 ? 2 : 0); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// the three bf16 pieces of (lo, hi), each pair packed (lo in the low half),
// rounded to nearest even: sdr_halves.cuh's split_pair<3>, two values a cvt
__device__ __forceinline__ void split3(float lo, float hi, uint32_t& w0, uint32_t& w1, uint32_t& w2) {
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(lo, hi);
  lo = __fsub_rn(lo, __low2float(p0));
  hi = __fsub_rn(hi, __high2float(p0));
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(lo, hi);
  lo = __fsub_rn(lo, __low2float(p1));
  hi = __fsub_rn(hi, __high2float(p1));
  w0 = bits(p0);
  w1 = bits(p1);
  w2 = bits(__floats2bfloat162_rn(lo, hi));
}

// torch's float GELUs: x / 2 (1 + erf(x / sqrt 2)) and x / 2 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
template <int kGelu>
__device__ __forceinline__ float gelu(float v) {
  if constexpr (kGelu == kErf) {
    return v * 0.5f * (1.f + erff(v * 0.70710678118654752f));
  } else {
    const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
    return 0.5f * v * (1.f + tanhf(inner));
  }
}

// -- the layer-norm epilogue ---------------------------------------------------
__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// a quad's partials v of its two frames, summed over the cluster's
// `blocks` blocks: the quad's first thread stores them in slot (rank, quad)
// of `buf` in every block, each store counted on that block's `bar`, whose
// phase the block's thread 0 opens for the bytes of all slots; once they
// have landed, every thread adds its quad's slots in rank order
__device__ __forceinline__ void cluster_sum(float (&v)[2], uint32_t bar, uint32_t buf, uint32_t parity, int quad,
                                            bool lead, int blocks) {
  if (quad == 0 && lead) mbar_expect_tx(bar, kQuads * blocks * 8);
  if (lead) {
    const uint32_t slot = buf + (cluster_rank() * kQuads + quad) * 8u;
    for (int r = 0; r < blocks; ++r) st_async(cluster_map(slot, r), v[0], v[1], cluster_map(bar, r));
  }
  mbar_wait_cluster(bar, parity);
  float s0 = 0.f, s1 = 0.f;
  for (int r = 0; r < blocks; ++r) {
    const float2 p = ld_shared2(buf + (r * kQuads + quad) * 8u);
    s0 += p.x;
    s1 += p.y;
  }
  v[0] = s0;
  v[1] = s1;
}

// The tile's LayerNorm over channels, in place on the accumulators (register
// 4 jj + e: frame e / 2 of the thread's two, channel o0 + 8 jj + e % 2):
// the mean, then the mean of the centred squares, each summed in the thread,
// its quad and the cluster; then (v - mean) rsqrt(var + eps) scale + shift.
// tile: the block's tiles before this one (the barriers' phase); bars the
// stage barriers, followed by the mean's and the variance's; stats their
// partials.
template <int kStages>
__device__ __forceinline__ void layer_norm(float (&acc)[64], const float* __restrict__ scale,
                                           const float* __restrict__ shift, float eps, int o0, int c_out, int tid,
                                           int cq, int tile, uint32_t bars, uint32_t stats) {
  const int quad = tid / 4, blocks = c_out / kBO;
  const uint32_t parity = tile & 1, mean_bar = bars + 8u * (2 * kStages);
  const float n = (float)c_out;
  float m[2] = {0.f, 0.f}, q[2] = {0.f, 0.f}, r[2];
#pragma unroll
  for (int e = 0; e < 64; ++e) m[e % 4 / 2] += acc[e];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] += __shfl_xor_sync(0xffffffffu, m[h], 1);
    m[h] += __shfl_xor_sync(0xffffffffu, m[h], 2);
  }
  cluster_sum(m, mean_bar, stats, parity, quad, cq == 0, blocks);
#pragma unroll
  for (int h = 0; h < 2; ++h) m[h] = __fdiv_rn(m[h], n);
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const float d = acc[e] - m[e % 4 / 2];
    q[e % 4 / 2] = fmaf(d, d, q[e % 4 / 2]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 1);
    q[h] += __shfl_xor_sync(0xffffffffu, q[h], 2);
  }
  cluster_sum(q, mean_bar + 8u, stats + kMaxCluster * kQuads * 8, parity, quad, cq == 0, blocks);
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = rsqrtf(__fdiv_rn(q[h], n) + eps);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + 8 * jj + e % 2;
      acc[4 * jj + e] = (acc[4 * jj + e] - m[e / 2]) * r[e / 2] * __ldg(scale + o) + __ldg(shift + o);
    }
  }
}

// Accumulator layout of m64n128k16: register 4 j + e of consumer thread t
// (warp w = t / 32 % 4, g = t % 32 / 4, c = t % 4) holds frame 16 w + g +
// 8 (e / 2) of its warpgroup's 64 and output channel 8 j + 2 c + e % 2. A
// fragment register m holds frame 16 w + g + 8 (m % 2) and the input
// channels 2 c + 8 (m / 2), + 1 of the step's 16 (the low half the first).
// The layer-norm epilogue: C_out / 128 blocks of a cluster, block r on
// channel tile r (the grid a whole number of clusters, so t % o_tiles is the
// rank); scale and shift the LayerNorm's, eps its epsilon (unread without it).
template <int kWidth, int kGelu, int kNorm>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gelu_kernel(const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ x,
                     const float* __restrict__ scale, const float* __restrict__ shift, float eps,
                     float* __restrict__ out, int batch, int c_in, int c_out, int t_in, int t_out) {
  using L = Layout<kWidth, kNorm>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto stage = [&](int s) { return base + (uint32_t)s * L::kStage; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform role split
  const int o_tiles = (c_out + kBO - 1) / kBO, f_tiles = (t_out + kBT - 1) / kBT;
  const int tiles = batch * f_tiles * o_tiles;
  const int k_blocks = c_in / kKC;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    if constexpr (kNorm == kLayer) {  // the statistics: thread 0's arrival, and the bytes of every block's partials
      mbar_init(bars + 8u * (2 * kStages), 1);
      mbar_init(bars + 8u * (2 * kStages + 1), 1);
    }
    mbar_init_fence();
  }
  if constexpr (kNorm == kLayer) {
    cluster_sync();  // no block arrives on a peer's barriers before the peer has made them
  } else {
    __syncthreads();
  }

  if (wg == kConsumers) {  // the producer warpgroup: its first warp issues every copy, a row a lane
    setmaxnreg_dec<kProducerRegs>();
    if (tid < kConsumers * 128 + 32) {
      const int r = tid % 32;
      const int mis = (r * t_in) & 3;  // floats from row r's 16-byte boundary to its sample s0
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int ot = t % o_tiles, ft = t / o_tiles % f_tiles, b = t / o_tiles / f_tiles;
        const int s0 = 2 * ft * kBT;  // the tile's first sample
        // row r's span: from the 16-byte boundary at or before its sample s0
        // to the tile's last sample or the row's end, rounded up to 16 bytes
        const int n = L::kSamples < t_in - s0 ? L::kSamples : t_in - s0;
        const uint32_t bytes = (uint32_t)((mis + n + 3) & ~3) * 4;
        uint32_t total = bytes;
#pragma unroll
        for (int o = 16; o > 0; o /= 2) total += __shfl_xor_sync(0xffffffffu, total, o);
        for (int kb = 0; kb < k_blocks; ++kb, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          if (r == 0) {
            mbar_expect_tx(full(s), kWidth * kPieces * L::kWBox + total);
#pragma unroll
            for (int j = 0; j < kWidth; ++j)
#pragma unroll
              for (int q = 0; q < kPieces; ++q)
                tma_load_3d(stage(s) + L::kAct + (j * kPieces + q) * L::kWBox, &tm_w, full(s), kb * kKC, ot * kBO,
                            q * kWidth + j);
          }
          __syncwarp();
          const size_t row = (size_t)b * c_in + (size_t)kb * kKC + r;
          bulk_load(stage(s) + r * kPitch * 4, x + row * t_in + s0 - mis, bytes, full(s));
        }
      }
    }
    return;
  }

  // a consumer warpgroup: frames wg * 64 .. + 64 of each tile
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid % 32, warp = tid / 32 % 4;
  const int g = lane / 4, cq = lane % 4;
  const int row0 = wg * 64 + warp * 16 + g;  // the thread's first frame in the tile; the other is row0 + 8
  const uint8_t* smem_base = smem_raw + (base - smem_u32(smem_raw));
  float acc[64], part[64];
  uint32_t tapf[kWidth][kPieces][4];  // the A fragments of every tap of one 16-channel step
  // samples 2 r, 2 r + 1 (v01) and 2 r + 2 (v2) of channel 16 kk + 2 c + 8 (m / 2) + e, frame r = row0 + 8 (m % 2)
  float2 v01[4][2];
  float v2[4][2];
  // row c of a stage holds its samples from (c t_in) & 3 floats in: the row
  // of x starts there past a 16-byte boundary (c_in t_in and the tile's
  // first sample are multiples of 4); for this thread's channels 2 cq + e
  // (mod 8) that offset is the same in every step
  int off[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) off[e] = (2 * cq + e) * kPitch + (((2 * cq + e) * t_in) & 3) + 2 * row0;
  auto load_step = [&](int s, int kk) {
    const float* act = reinterpret_cast<const float*>(smem_base + (size_t)s * L::kStage);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float* at = act + off[e] + (16 * kk + 8 * (m / 2)) * kPitch + 16 * (m % 2);
        v01[m][e] = make_float2(at[0], at[1]);
        if constexpr (kWidth == 3) v2[m][e] = at[2];
      }
    }
  };
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int ot = t % o_tiles, ft = t / o_tiles % f_tiles, b = t / o_tiles / f_tiles;
    // each step's first product overwrites part (scale_d 0); set here, part
    // holds nothing live through the epilogue (the products read it as "+f")
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
    mbar_wait(full(it % kStages), (it / kStages) & 1);
    load_step(it % kStages, 0);
    for (int kb = 0; kb < k_blocks; ++kb, ++it) {
      const int s = it % kStages;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        // the A fragments of every tap: x[c, 2 t + j] in three pieces
#pragma unroll
        for (int j = 0; j < kWidth; ++j) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float lo = j == 0 ? v01[m][0].x : (j == 1 ? v01[m][0].y : v2[m][0]);
            const float hi = j == 0 ? v01[m][1].x : (j == 1 ? v01[m][1].y : v2[m][1]);
            split3(lo, hi, tapf[j][0][m], tapf[j][1][m], tapf[j][2][m]);
          }
        }
        // the step's partial: every tap's small products, then the main ones,
        // so that only the last kWidth additions round at the partial's magnitude
        wg_fence();
#pragma unroll
        for (int q = 0; q < 6; ++q) {
#pragma unroll
          for (int j = 0; j < kWidth; ++j) {
            const uint64_t desc_w = desc_sw64(stage(s) + L::kAct + (j * kPieces + piece_w(q)) * L::kWBox + kk * 32);
            wgmma_rs_n128<0>(part, tapf[j][piece_x(q)], desc_w, q > 0 || j > 0);
          }
        }
        wg_commit();
        // the next step's samples, read while the products run
        if (kk + 1 < kKC / 16) {
          load_step(s, kk + 1);
        } else if (kb + 1 < k_blocks) {
          mbar_wait(full((it + 1) % kStages), ((it + 1) / kStages) & 1);
          load_step((it + 1) % kStages, 0);
        }
        wg_wait<0>();
        reg_fence(part);
        if (kk == kKC / 16 - 1) mbar_arrive(empty(s));  // the stage's products are done
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += part[e];
      }
    }

    // the epilogue: gelu from registers to out, 8 frames x 4 channels a warp store
    const int o0 = ot * kBO + 2 * cq, f0 = ft * kBT + row0;
    if constexpr (kNorm == kLayer)
      layer_norm<kStages>(acc, scale, shift, eps, o0, c_out, tid, cq, it / k_blocks - 1, bars, base + L::kStatOff);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = gelu<kGelu>(acc[4 * jj + e]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + 8 * jj + e % 2, f = f0 + 8 * (e / 2);
        if (o < c_out && f < t_out) out[((size_t)b * c_out + o) * t_out + f] = y[e];
      }
    }
  }
}

template <int kWidth, int kGelu, int kNorm>
cudaError_t launch(const CUtensorMap& tm_w, const float* x, const float* scale, const float* shift, float eps,
                   float* out, int batch, int c_in, int c_out, int t_in, int t_out, cudaStream_t stream) {
  constexpr size_t smem = Layout<kWidth, kNorm>::kBytes;
  const auto kernel = conv_gelu_kernel<kWidth, kGelu, kNorm>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // a persistent grid: one block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)batch * ((t_out + kBT - 1) / kBT) * ((c_out + kBO - 1) / kBO);
  if constexpr (kNorm == kNone) {
    conv_gelu_kernel<kWidth, kGelu, kNorm><<<(int)(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(
        tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out);
    return cudaGetLastError();
  } else {  // clusters of c_out / 128 blocks, as many as the card holds at once
    const int blocks = c_out / kBO;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(blocks * (sms / blocks)));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    const long long frame_tiles = tiles / blocks;
    cfg.gridDim = dim3((unsigned)(blocks * (frame_tiles < clusters ? frame_tiles : clusters)));
    return cudaLaunchKernelEx(&cfg, kernel, tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out);
  }
}

template <int kNorm>
cudaError_t launch_any(const CUtensorMap& tm_w, const float* x, const float* scale, const float* shift, float eps,
                       float* out, int batch, int c_in, int c_out, int t_in, int t_out, int width, int gelu,
                       cudaStream_t stream) {
  if (width == 2 && gelu == kErf)
    return launch<2, kErf, kNorm>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, stream);
  if (width == 2)
    return launch<2, kTanh, kNorm>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, stream);
  if (gelu == kErf)
    return launch<3, kErf, kNorm>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, stream);
  return launch<3, kTanh, kNorm>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, stream);
}

// -- conv 0 of the layer-norm encoder ------------------------------------------
// out = gelu(LN_channels(conv1d(x, w, stride 5))), x (B, 1, T_in), w (512, 1,
// 10): out[c, t] = sum_j w[c, j] x[5 t + j], ten float32 FMAs an output in j
// order, no split (the tensor cores would need a K of 16 for 10 products).
// Bound by its write: 512 floats a frame, 6.7 GB at 64 rows of 16 s, 2 ms
// at 3.35 TB/s; its arithmetic (the FMAs, the statistics, the GELU) about
// as long on the CUDA cores.
// A persistent grid of 512-thread blocks over tiles of 64 frames x all 512
// channels: warp w holds channels 32 w .. 32 w + 31, lane l frames l and l +
// 32 (a warp's store of a channel covers 32 frames, 128 contiguous bytes),
// the 64 values in registers; the weights (padded to 12 a channel: three
// 16-byte broadcast reads), the LayerNorm's scale and shift and the tile's
// samples in shared memory, the next tile's samples copied (cp.async) while
// this one's statistics form. Statistics: numerics.layer_norm's two passes,
// per frame the thread's 32 channels, then the 16 warps' partials in warp
// order through shared memory. Frames at or past T_out are not stored;
// the stores stream (st.global.cs: with write-back stores the kernel took
// 26 % longer, its arithmetic alone 44 % of that).
namespace c0 {
constexpr int kC = 512, kK = 10, kS = 5;
constexpr int kThreads = 512, kWarps = kThreads / 32, kCW = kC / kWarps;  // 32 channels a warp
constexpr int kBT = 64;                        // frames a tile, two a lane
constexpr int kSamples = kS * (kBT - 1) + kK;  // 325
constexpr int kXPitch = 328;
constexpr int kWPitch = 12;
}  // namespace c0

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

template <int kGelu>
__global__ void __launch_bounds__(c0::kThreads, 1)
    conv0_ln_gelu_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ scale,
                         const float* __restrict__ shift, float eps, float* __restrict__ out, int batch, int t_in,
                         int t_out) {
  __shared__ __align__(16) float ws[c0::kC * c0::kWPitch];
  __shared__ float sc[c0::kC], sh[c0::kC];
  __shared__ float xs[2][c0::kXPitch];
  __shared__ float red[2][c0::kWarps][c0::kBT];  // the warps' partials of the mean and of the variance
  const int tid = threadIdx.x, lane = tid % 32, wp = tid / 32;
  const int f_tiles = (t_out + c0::kBT - 1) / c0::kBT;
  const long long tiles = (long long)batch * f_tiles;
  for (int i = tid; i < c0::kC * c0::kWPitch; i += c0::kThreads) {
    const int c = i / c0::kWPitch, j = i % c0::kWPitch;
    ws[i] = j < c0::kK ? w[c * c0::kK + j] : 0.f;
  }
  for (int i = tid; i < c0::kC; i += c0::kThreads) {
    sc[i] = scale[i];
    sh[i] = shift[i];
  }
  // the samples of tile t, zeros past the row's end
  auto fetch = [&](long long t, int buf) {
    const int s0 = (int)(t % f_tiles) * c0::kBT * c0::kS;
    const float* row = x + (size_t)(t / f_tiles) * t_in;
    for (int i = tid; i < c0::kSamples; i += c0::kThreads) {
      if (s0 + i < t_in) {
        cp_async4(&xs[buf][i], row + s0 + i);
      } else {
        xs[buf][i] = 0.f;
      }
    }
  };
  if (blockIdx.x < tiles) fetch(blockIdx.x, 0);
  cp_async_wait_all();
  __syncthreads();
  int it = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int buf = it & 1;
    const int b = (int)(t / f_tiles), f0 = (int)(t % f_tiles) * c0::kBT;
    float xv[2][c0::kK];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < c0::kK; ++j) xv[h][j] = xs[buf][c0::kS * (lane + 32 * h) + j];
    float acc[c0::kCW][2];
#pragma unroll
    for (int i = 0; i < c0::kCW; ++i) {
      const float4* wv = reinterpret_cast<const float4*>(ws + (wp * c0::kCW + i) * c0::kWPitch);
      const float4 w0 = wv[0], w1 = wv[1], w2 = wv[2];
      const float wj[c0::kK] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = wj[0] * xv[h][0];
#pragma unroll
        for (int j = 1; j < c0::kK; ++j) v = fmaf(wj[j], xv[h][j], v);
        acc[i][h] = v;
      }
    }
    float m[2] = {0.f, 0.f}, q[2] = {0.f, 0.f}, r[2];
#pragma unroll
    for (int i = 0; i < c0::kCW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) m[h] += acc[i][h];
#pragma unroll
    for (int h = 0; h < 2; ++h) red[0][wp][lane + 32 * h] = m[h];
    if (t + gridDim.x < tiles) fetch(t + gridDim.x, buf ^ 1);  // read by tile it + 1, after both barriers below
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < c0::kWarps; ++v) s += red[0][v][lane + 32 * h];
      m[h] = __fdiv_rn(s, (float)c0::kC);
    }
#pragma unroll
    for (int i = 0; i < c0::kCW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = acc[i][h] - m[h];
        q[h] = fmaf(d, d, q[h]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) red[1][wp][lane + 32 * h] = q[h];
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < c0::kWarps; ++v) s += red[1][v][lane + 32 * h];
      r[h] = rsqrtf(__fdiv_rn(s, (float)c0::kC) + eps);
    }
#pragma unroll
    for (int i = 0; i < c0::kCW; ++i) {
      const int c = wp * c0::kCW + i;
      float* row = out + ((size_t)b * c0::kC + c) * t_out + f0 + lane;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (f0 + lane + 32 * h < t_out) __stcs(row + 32 * h, gelu<kGelu>((acc[i][h] - m[h]) * r[h] * sc[c] + sh[c]));
    }
  }
}

template <int kGelu>
cudaError_t launch_conv0(const float* x, const float* w, const float* scale, const float* shift, float eps, float* out,
                         int batch, int t_in, int t_out, cudaStream_t stream) {
  const auto kernel = conv0_ln_gelu_kernel<kGelu>;
  int dev = 0, sms = 0, per_sm = 0;  // a persistent grid: as many blocks as the card holds at once
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, c0::kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)batch * ((t_out + c0::kBT - 1) / c0::kBT);
  const long long grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  conv0_ln_gelu_kernel<kGelu><<<(int)grid, c0::kThreads, 0, stream>>>(x, w, scale, shift, eps, out, batch, t_in,
                                                                       t_out);
  return cudaGetLastError();
}

}  // namespace convg
}  // namespace

// x (batch, c_in, t_in) float32, contiguous, 16-byte aligned; pieces (3, width, c_out, c_in)
// bf16, contiguous, 16-byte aligned (ops/conv_gelu.py::split_pieces); out
// (batch, c_out, t_out) float32, t_out = (t_in - width) / 2 + 1. c_in a
// multiple of 32, c_out of 8, width 2 or 3, gelu 0 (erf) or 1 (tanh). With
// scale and shift (c_out float32 each; both or neither) the LayerNorm over
// channels with epsilon eps comes before the GELU: c_out then a multiple of
// 128, at most 8 x 128.
extern "C" int fsem_conv_gelu(const float* x, const void* pieces, const float* scale, const float* shift, float* out,
                              int batch, int c_in, int c_out, int t_in, int width, int gelu, float eps,
                              void* stream_ptr) {
  using namespace convg;
  const bool norm = scale != nullptr;
  if (batch <= 0 || c_in <= 0 || c_in % kKC || c_out <= 0 || c_out % 8 || (width != 2 && width != 3) ||
      t_in < width || (gelu != kErf && gelu != kTanh) || reinterpret_cast<uintptr_t>(x) % 16 ||
      norm != (shift != nullptr) || (norm && (c_out % kBO || c_out > kMaxCluster * kBO)))
    return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - width) / 2 + 1;
  if ((long long)batch * ((t_out + kBT - 1) / kBT) * ((c_out + kBO - 1) / kBO) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_w;  // (c_in, c_out, piece x width + tap): K-major boxes of 32 channels x 128 outputs
  const cuuint64_t dims[3] = {(cuuint64_t)c_in, (cuuint64_t)c_out, (cuuint64_t)(kPieces * width)};
  const cuuint64_t strides[2] = {(cuuint64_t)c_in * 2, (cuuint64_t)c_out * c_in * 2};
  if (!sm90::tensor_map(&tm_w, pieces, 3, dims, strides, kBO, 2, 64)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(norm ? launch_any<kLayer>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, width,
                                         gelu, stream)
                    : launch_any<kNone>(tm_w, x, scale, shift, eps, out, batch, c_in, c_out, t_in, t_out, width,
                                        gelu, stream));
}

// x (batch, 1, t_in), w (512, 1, 10), scale and shift (512) float32,
// contiguous; out (batch, 512, t_out) float32, t_out = (t_in - 10) / 5 + 1;
// gelu 0 (erf) or 1 (tanh); eps the LayerNorm's epsilon.
extern "C" int fsem_conv0_ln_gelu(const float* x, const float* w, const float* scale, const float* shift, float* out,
                                  int batch, int t_in, int gelu, float eps, void* stream_ptr) {
  using namespace convg;
  if (batch <= 0 || t_in < c0::kK || (gelu != kErf && gelu != kTanh)) return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - c0::kK) / c0::kS + 1;
  if ((long long)batch * ((t_out + c0::kBT - 1) / c0::kBT) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(gelu == kErf ? launch_conv0<kErf>(x, w, scale, shift, eps, out, batch, t_in, t_out, stream)
                            : launch_conv0<kTanh>(x, w, scale, shift, eps, out, batch, t_in, t_out, stream));
}
