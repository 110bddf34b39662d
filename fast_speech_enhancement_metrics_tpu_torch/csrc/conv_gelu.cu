// HuBERT's conv feature encoder, convs 1-6: out = gelu(conv1d(x, w, stride 2))
// in float32 on the bf16 tensor cores, the GELU in the epilogue.
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
// Shared memory: two stages of the float32 tile (32 x 264 x 4 = 33 KB) and
// the weight pieces (k x 3 x 8 KB), 210 KB at k = 3.
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

template <int kWidth>
struct Layout {
  static constexpr int kSamples = 2 * (kBT - 1) + kWidth;  // samples a tile's frames read
  static constexpr int kAct = kKC * kPitch * 4;
  static constexpr int kWBox = kBO * 64;  // one tap and piece: 128 outputs x 64 bytes
  static constexpr int kStage = kAct + kWidth * kPieces * kWBox;
  static constexpr int kStages = 2;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr size_t kBytes = kBarOff + 8 * 2 * kStages + 1024;  // + slack to align the base to 1024
  static_assert(kSamples <= kPitch && kAct % 1024 == 0 && kStage % 1024 == 0, "tile layout");
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

// one contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, counted on an mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
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

// Accumulator layout of m64n128k16: register 4 j + e of consumer thread t
// (warp w = t / 32 % 4, g = t % 32 / 4, c = t % 4) holds frame 16 w + g +
// 8 (e / 2) of its warpgroup's 64 and output channel 8 j + 2 c + e % 2. A
// fragment register m holds frame 16 w + g + 8 (m % 2) and the input
// channels 2 c + 8 (m / 2), + 1 of the step's 16 (the low half the first).
template <int kWidth, int kGelu>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gelu_kernel(const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ x, float* __restrict__ out,
                     int batch, int c_in, int c_out, int t_in, int t_out) {
  using L = Layout<kWidth>;
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
    mbar_init_fence();
  }
  __syncthreads();

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

template <int kWidth, int kGelu>
cudaError_t launch(const CUtensorMap& tm_w, const float* x, float* out, int batch, int c_in, int c_out, int t_in,
                   int t_out, cudaStream_t stream) {
  constexpr size_t smem = Layout<kWidth>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(conv_gelu_kernel<kWidth, kGelu>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // a persistent grid: one block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles =
      (long long)batch * ((t_out + kBT - 1) / kBT) * ((c_out + kBO - 1) / kBO);
  conv_gelu_kernel<kWidth, kGelu><<<(int)(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(
      tm_w, x, out, batch, c_in, c_out, t_in, t_out);
  return cudaGetLastError();
}

}  // namespace convg
}  // namespace

// x (batch, c_in, t_in) float32, contiguous, 16-byte aligned; pieces (3, width, c_out, c_in)
// bf16, contiguous, 16-byte aligned (ops/conv_gelu.py::split_pieces); out
// (batch, c_out, t_out) float32, t_out = (t_in - width) / 2 + 1. c_in a
// multiple of 32, c_out of 8, width 2 or 3, gelu 0 (erf) or 1 (tanh).
extern "C" int fsem_conv_gelu(const float* x, const void* pieces, float* out, int batch, int c_in, int c_out,
                              int t_in, int width, int gelu, void* stream_ptr) {
  using namespace convg;
  if (batch <= 0 || c_in <= 0 || c_in % kKC || c_out <= 0 || c_out % 8 || (width != 2 && width != 3) ||
      t_in < width || (gelu != kErf && gelu != kTanh) || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int t_out = (t_in - width) / 2 + 1;
  if ((long long)batch * ((t_out + kBT - 1) / kBT) * ((c_out + kBO - 1) / kBO) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm_w;  // (c_in, c_out, piece x width + tap): K-major boxes of 32 channels x 128 outputs
  const cuuint64_t dims[3] = {(cuuint64_t)c_in, (cuuint64_t)c_out, (cuuint64_t)(kPieces * width)};
  const cuuint64_t strides[2] = {(cuuint64_t)c_in * 2, (cuuint64_t)c_out * c_in * 2};
  if (!sm90::tensor_map(&tm_w, pieces, 3, dims, strides, kBO, 2, 64)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (width == 2)
    return (int)(gelu == kErf ? launch<2, kErf>(tm_w, x, out, batch, c_in, c_out, t_in, t_out, stream)
                              : launch<2, kTanh>(tm_w, x, out, batch, c_in, c_out, t_in, t_out, stream));
  return (int)(gelu == kErf ? launch<3, kErf>(tm_w, x, out, batch, c_in, c_out, t_in, t_out, stream)
                            : launch<3, kTanh>(tm_w, x, out, batch, c_in, c_out, t_in, t_out, stream));
}

