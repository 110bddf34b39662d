// HuBERT's / WavLM's positional conv stage in one pass:
//   out = x + gelu_erf(conv_g(bn(x)) + b)[:T]
// on (B, T, d) float32 rows, channels last: a grouped conv of width 128
// (16 groups of c_g = 48 or 64 channels), zero padding 64 on both sides
// after the batch-norm affine, the even width's last frame dropped, the
// bias, the exact GELU and the residual, in float32 on the bf16 tensor
// cores.
//
// Replaces no Pallas kernel: the JAX package leaves this conv to XLA
// (models/hubert.py::hubert_hidden_state, lax.conv_general_dilated at
// "highest", bf16x6 MXU passes on the TPU). On the card it ran on cuDNN's
// float32 implicit GEMM on the CUDA cores, over transposed views, with the
// slice, bias, GELU and residual as separate passes; TF32 would miss the
// float32 class.
//
// As a GEMM per (row, group): D (frames, c_g) = sum_j X_j (frames, c_g)
// W_j (c_g, c_g) over the taps j < 128, X_j the group's channels of bn(x)
// shifted by j - 64 frames. K = 128 c_g (6144 / 8192), N = c_g. At
// mHuBERT-147's widths and 128 rows of 799 frames, 0.965 TFLOP a call
// (WavLM-Large 1.716). What bounds it on this card: operations, six bf16
// products per float32 product on the tensor cores (989 / 6 TFLOP/s); the
// bytes (x read, out written, once) are 1 % of that time.
//
// Precision: bf16x6, the float32 class of conv_gelu.cu. w arrives as three
// bf16 pieces, split once (ops/pos_conv.py::split_pieces, cached by the
// encoder); bn(x) is split into three pieces as the tile's window is
// filled. A product is the six piece products of order <= 2, x-piece by
// w-piece (1,1), (0,2), (2,0), (0,1), (1,0), (0,0), each exact in the
// tensor cores. Each 16-channel step of a tap forms a float32 partial of
// its own, the small products first, added to the tile's sum in float32:
// the tensor cores round each addition at the running sum's magnitude, and
// one sum over all K read 8x cuDNN's float32 error in conv_gelu.cu.
//
// Design. x is the small operand and the weights are the stream. A
// persistent grid of one block per SM walks tiles of 256 frames of one
// (group, row), group-major, so that a group's weight pieces (1.77 MB at
// c_g 48, 3.1 MB at 64) stay in L2 while the grid works on it. 640 threads:
//   producer warpgroup (24 registers after setmaxnreg): one thread streams
//     the group's taps through a ring of stages in shared memory, one tap
//     (three pieces, c_g x c_g each, 13.8 / 24.6 KB) a stage, each one
//     contiguous TMA bulk copy: the wrapper lays the pieces out as the
//     products read them, so no tensor map is needed.
//   four consumer warpgroups (112 registers), 64 frames each: first, all
//     512 together fill the tile's window, frames t0 - 64 .. t0 + 319 of the
//     group's channels, straight from global memory (a row of 8 channels a
//     thread, BN in float32 as the reference rounds it, __fmul_rn then
//     __fadd_rn; frames outside [0, T) are zero, as the conv pads after BN),
//     split into three bf16 pieces stored as panels of 8 channels, each
//     panel all 384 rows x 16 bytes. Filling takes ~1 % of a tile's time, so
//     the window is not double-buffered. Then per tap j and 16-channel step,
//     a warp takes its 16 rows of the window shifted by j rows, each
//     piece's m16k16 A fragment by one ldmatrix (8 rows x 16 bytes a
//     matrix: no bank conflicts at any shift), and the warpgroup runs six
//     register-A m64nNk16 products against the tap's weight pieces (B from
//     shared memory, K-major without swizzle: core matrices of 8 output
//     channels x 16 bytes, LBO 16 c_g between panels, SBO 128). A from
//     shared memory as well read 56 % / 68 % of the bound at c_g 48 / 64
//     (shared memory, 4 KB a product at N = 64). A warpgroup waits for its
//     step's products before it adds the partial (a second partial buffer,
//     added while the next step's products run, made ptxas serialize every
//     product: 35-43 %); the other three warpgroups' products keep the
//     tensor cores busy meanwhile. A warpgroup whose frames all lie at or
//     past T runs no product.
// Epilogue: + b, the erf GELU and + x (read again from global memory, a
// float2 a thread) from the registers straight to out (B, T, d). Frames at
// or past T are not stored.
//
// Shared memory: the window (3 pieces x 384 rows x 2 c_g bytes: 110.6 /
// 147.5 KB) and 8 / 3 stages of weights (110.6 / 73.7 KB).
#include "sdr_halves.cuh"
#include "sm90.cuh"

namespace {
namespace posc {

using namespace sm90;

constexpr int kTaps = 128;       // the conv's width
constexpr int kPad = kTaps / 2;  // zero frames before the first (and, less one, after the last)
constexpr int kBT = 256;         // frames a tile: four consumer warpgroups x one m64 sub-tile
constexpr int kRows = kBT + kTaps;  // window rows (383 read, one more to keep 16-byte multiples)
constexpr int kPanel = kRows * 16;  // bytes of one 8-channel panel of the window
constexpr int kPieces = 3;
constexpr int kConsumers = 4;
constexpr int kThreads = (kConsumers + 1) * 128;
// the block holds 640 x 96 registers from its launch (65 536 / 640, in steps of 8); setmaxnreg
// hands them on within that: 128 x 24 + 512 x 112 <= 640 x 96
constexpr int kProducerRegs = 24, kConsumerRegs = 112;
constexpr int kSmemLimit = 232448;

template <int kCg>
struct Layout {
  static constexpr int kPiece = kPanel * (kCg / 8);   // one piece of the window
  static constexpr int kWin = kPieces * kPiece;
  static constexpr int kWPiece = kCg * kCg * 2;       // one piece of one tap's weights
  static constexpr int kStage = kPieces * kWPiece;    // one tap
  static constexpr int kStages = (kSmemLimit - 1024 - 256 - kWin) / kStage;
  static constexpr int kBarOff = kWin + kStages * kStage;
  static constexpr size_t kBytes = kBarOff + 8 * 2 * kStages + 1024;  // + slack to align the base
  static_assert(kCg == 48 || kCg == 64, "channels a group");
  static_assert(kStages >= 3 && kBytes <= kSmemLimit, "shared memory");
};

// the pieces of the x-factor and of the w-factor of product t: (1,1),
// (0,2), (2,0), (0,1), (1,0), (0,0)
__host__ __device__ constexpr int piece_x(int t) { return t == 0 || t == 4 ? 1 : (t == 2 ? 2 : 0); }
__host__ __device__ constexpr int piece_w(int t) { return t == 0 || t == 3 ? 1 : (t == 1 ? 2 : 0); }

// K-major operand without swizzle: core matrices of 8 rows x 16 bytes, lbo
// bytes between the two core matrices of a k16 step, sbo between 8-row groups
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// D (64 x 48, fp32) [+]= A (64 x 16) B (16 x 48): A from registers (the
// m16n8k16 A fragments of the four warps), B from shared memory K-major
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int kCg>
__device__ __forceinline__ void wgmma_rs(float (&d)[kCg / 2], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  if constexpr (kCg == 48) wgmma_rs_n48(d, a, desc_b, scale_d);
  if constexpr (kCg == 64) wgmma_rs_n64<0>(d, a, desc_b, scale_d);
}

// four 8 x 8 bf16 matrices from shared memory, lane l giving row l % 8 of
// matrix l / 8; register i holds matrix i's row l / 4, columns 2 (l % 4), + 1
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// torch's exact GELU: x / 2 (1 + erf(x / sqrt 2))
__device__ __forceinline__ float gelu_erf(float v) { return v * 0.5f * (1.f + erff(v * 0.70710678118654752f)); }

// One 16-channel step of one tap for this warpgroup's sub-tile: the three
// pieces' A fragments from the window (ldmatrix, lane_a the lane's row and
// panel at tap 0 and step 0, shifted by 16 j bytes for tap j), six products
// into the partial (the first overwrites it), small terms first, then the
// partial added to the sum once they are done.
template <int kCg>
__device__ __forceinline__ void step(float (&acc)[kCg / 2], float (&part)[kCg / 2], uint32_t lane_a, int j,
                                     uint32_t wst, int kk) {
  using L = Layout<kCg>;
  uint32_t af[kPieces][4];
#pragma unroll
  for (int p = 0; p < kPieces; ++p) ldmatrix_x4(af[p], lane_a + p * L::kPiece + 2 * kk * kPanel + j * 16);
  wg_fence();
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const uint64_t db = desc_plain(wst + piece_w(q) * L::kWPiece + 2 * kk * kCg * 16, kCg * 16, 128);
    wgmma_rs<kCg>(part, af[piece_x(q)], db, q > 0);
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(part);
#pragma unroll
  for (int e = 0; e < kCg / 2; ++e) acc[e] += part[e];
}

// Accumulator layout of m64nNk16: register 4 j + e of consumer thread t
// (warp w = t / 32 % 4, g = t % 32 / 4, c = t % 4) holds frame 16 w + g +
// 8 (e / 2) of its sub-tile's 64 and output channel 8 j + 2 c + e % 2.
template <int kCg>
__global__ void __launch_bounds__(kThreads, 1)
    pos_conv_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ pieces,
                    const float* __restrict__ bn_scale, const float* __restrict__ bn_shift,
                    const float* __restrict__ bias, float* __restrict__ out, int batch, int frames, int groups) {
  using L = Layout<kCg>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t wst0 = base + L::kWin;
  const uint32_t bars = base + L::kBarOff;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  auto stage = [&](int s) { return wst0 + (uint32_t)s * L::kStage; };

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform role split
  const int f_tiles = (frames + kBT - 1) / kBT;
  const int tiles = groups * batch * f_tiles;
  const int d = groups * kCg;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {  // the producer warpgroup: one thread streams the taps
    setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers * 128) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const __nv_bfloat16* src = pieces + (size_t)(t / (batch * f_tiles)) * kTaps * (L::kStage / 2);
        for (int j = 0; j < kTaps; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
          mbar_expect_tx(full(s), L::kStage);
          bulk_load(stage(s), src + (size_t)j * (L::kStage / 2), L::kStage, full(s));
        }
      }
    }
    return;
  }

  // a consumer warpgroup: frames wg * 64 .. + 64 of each tile
  setmaxnreg_inc<kConsumerRegs>();
  const int lane = tid % 32, warp = tid / 32 % 4;
  const int gq = lane / 4, cq = lane % 4;
  uint8_t* const win_ptr = smem_raw + (base - smem_u32(smem_raw));
  float acc[kCg / 2], part[kCg / 2];
  // the window row and panel of this lane's ldmatrix address: row 16 w + l % 8
  // (+ 8 for matrices 1 and 3) of the warpgroup's 64, panel + 1 for matrices 2 and 3
  const uint32_t lane_a =
      base + (uint32_t)(lane / 16) * kPanel + (uint32_t)(wg * 64 + warp * 16 + lane % 8 + 8 * (lane / 8 % 2)) * 16;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int g = t / (batch * f_tiles), b = t / f_tiles % batch, t0 = t % f_tiles * kBT;
    const float* xg = x + (size_t)b * frames * d + g * kCg;  // frame 0, the group's channel 0

    // the window: frames t0 - 64 + r, r < kRows, as three bf16 pieces; a
    // thread fills one row of 8 channels at a time (rows fastest: a warp's
    // stores are 512 contiguous bytes)
    named_sync(1, kConsumers * 128);  // every consumer's products have read the last window
#pragma unroll 4
    for (int u = tid; u < kRows * (kCg / 8); u += kConsumers * 128) {
      const int r = u % kRows, c8 = u / kRows, f = t0 - kPad + r;
      float v[8];
      if (f >= 0 && f < frames) {
        const float4* src = reinterpret_cast<const float4*>(xg + (size_t)f * d + 8 * c8);
        const float4 a = __ldg(src), bb = __ldg(src + 1);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = bb.x, v[5] = bb.y, v[6] = bb.z, v[7] = bb.w;
        if (bn_scale != nullptr) {
          const float4* sc = reinterpret_cast<const float4*>(bn_scale + g * kCg + 8 * c8);
          const float4* sh = reinterpret_cast<const float4*>(bn_shift + g * kCg + 8 * c8);
          const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1), h0 = __ldg(sh), h1 = __ldg(sh + 1);
          const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(__fmul_rn(v[e], sv[e]), hv[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      uint32_t w[4][kPieces];  // pair e's pieces
#pragma unroll
      for (int e = 0; e < 4; ++e) halves::split_pair<kPieces>(v[2 * e], v[2 * e + 1], w[e]);
      uint8_t* dst = win_ptr + c8 * kPanel + r * 16;
#pragma unroll
      for (int q = 0; q < kPieces; ++q)
        *reinterpret_cast<uint4*>(dst + q * L::kPiece) = make_uint4(w[0][q], w[1][q], w[2][q], w[3][q]);
    }
    named_sync(1, kConsumers * 128);  // the window is whole (ldmatrix reads it: no proxy fence)

    // this warpgroup's sub-tile: frames m0 .. m0 + 63, products only if it holds one before T
    const int m0 = t0 + wg * 64;
#pragma unroll
    for (int e = 0; e < kCg / 2; ++e) acc[e] = 0.f;
    for (int j = 0; j < kTaps; ++j, ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      if (m0 < frames) {
#pragma unroll
        for (int kk = 0; kk < kCg / 16; ++kk) step<kCg>(acc, part, lane_a, j, stage(s), kk);
      }
      mbar_arrive(empty(s));  // this warpgroup's products of the tap are done
    }

    // the epilogue: + b, gelu, + x, from registers to out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = m0 + warp * 16 + gq + 8 * h;
      if (f >= frames) continue;
      const size_t row = ((size_t)b * frames + f) * d + g * kCg;
#pragma unroll
      for (int jj = 0; jj < kCg / 8; ++jj) {
        const int o = 8 * jj + 2 * cq;
        const float2 bo = __ldg(reinterpret_cast<const float2*>(bias + g * kCg + o));
        const float2 xr = __ldg(reinterpret_cast<const float2*>(x + row + o));
        float2 y;
        y.x = xr.x + gelu_erf(acc[4 * jj + 2 * h] + bo.x);
        y.y = xr.y + gelu_erf(acc[4 * jj + 2 * h + 1] + bo.y);
        *reinterpret_cast<float2*>(out + row + o) = y;
      }
    }
  }
}

template <int kCg>
cudaError_t launch(const float* x, const void* pieces, const float* scale, const float* shift, const float* bias,
                   float* out, int batch, int frames, int groups, cudaStream_t stream) {
  constexpr size_t smem = Layout<kCg>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(pos_conv_kernel<kCg>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;  // a persistent grid: one block per SM
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)groups * batch * ((frames + kBT - 1) / kBT);
  pos_conv_kernel<kCg><<<(int)(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(pieces), scale, shift, bias, out, batch, frames, groups);
  return cudaGetLastError();
}

}  // namespace posc
}  // namespace

// x (batch, frames, channels) float32, contiguous, 16-byte aligned; pieces
// (groups, 128, 3, c_g / 8, c_g, 8) bf16, contiguous, 16-byte aligned
// (ops/pos_conv.py::split_pieces); bn_scale and bn_shift (channels) float32,
// 16-byte aligned, both or neither (null); bias (channels) float32; out like
// x. channels = groups x c_g, c_g 48 or 64.
extern "C" int fsem_pos_conv(const float* x, const void* pieces, const float* bn_scale, const float* bn_shift,
                             const float* bias, float* out, int batch, int frames, int channels, int groups,
                             void* stream_ptr) {
  using namespace posc;
  if (batch <= 0 || frames <= 0 || groups <= 0 || channels % groups || (bn_scale == nullptr) != (bn_shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const int cg = channels / groups;
  if ((cg != 48 && cg != 64) || reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 8 ||
      reinterpret_cast<uintptr_t>(pieces) % 16 || reinterpret_cast<uintptr_t>(bias) % 8 ||
      reinterpret_cast<uintptr_t>(bn_scale) % 16 || reinterpret_cast<uintptr_t>(bn_shift) % 16)
    return (int)cudaErrorInvalidValue;
  if ((long long)groups * batch * ((frames + kBT - 1) / kBT) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return (int)(cg == 48 ? launch<48>(x, pieces, bn_scale, bn_shift, bias, out, batch, frames, groups, stream)
                        : launch<64>(x, pieces, bn_scale, bn_shift, bias, out, batch, frames, groups, stream));
}
