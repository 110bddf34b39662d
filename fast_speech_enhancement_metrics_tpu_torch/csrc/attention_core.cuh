// Non-causal attention in float32 over one (row, head) per grid (y, z), 64
// queries per block: the precision="highest" arm of A9 / A15 (sdpa_f32.cu,
// (B H, T, D) tensors). The bf16 A9 / A15 and A7's attention (so A11's) run
// flash_sm90.cuh.
//
// A block of 4 warps owns 64 queries; each warp owns 16. Key tiles stream
// through shared memory (K/V of one head at 40 000 frames is 10 MB, far
// beyond one SM, so nothing is resident as in the TPU kernel's VMEM). Per
// key tile: S = Q K^T by SIMT FMAs in fp32 (no TF32) into the warp's
// scratch, the softmax element by element (P in place of S), then P V into
// an fp32 accumulator in shared memory; K and V take turns in one tile so
// that a head of 128 fits.
//
// Template parameters:
// * HDP: the head width zero-padded to a multiple of 16, at most 128. Rows
//   load zeros past the real width hd, so the padded columns add nothing;
// * kMode: kExp2 (p = 2^clamp(s, -100, 60); the scale and log2 e are in q
//   already), kExp2Bf16 (jnp.exp2 of the clamped logit in bf16:
//   bf16(exp(bf16(bf16(s) * bf16(ln 2))))), kExact (a first pass over all
//   key tiles for the row max, then p = exp(s - max), so p is rounded
//   against the true max as on the TPU), kOnline (the upstream JAX flash
//   kernel's online softmax: s *= scale, per key tile of 128 the running
//   max m, p = exp(s - m_next), l_next = sum p + exp(m_prev - m_next) l_prev,
//   acc = acc * (l_corr / l_next) + (p V) / l_next, so acc is normalised at
//   every step).
//
// Keys at or past t_len contribute p = 0 (the JAX kernels' masked keys; the
// exp2 modes' clamped 2^-100 per padded key arrives as l_pad). The kOnline
// arm walks n_keys keys (t_len padded to the flash kernel's 512) so its
// per-tile rescales match the upstream kernel's. The output is ctx / l (or
// acc); queries past t_len and columns past hd are not stored.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace {
namespace attn {

enum Softmax { kExp2 = 0, kExp2Bf16 = 1, kExact = 2, kOnline = 3 };
constexpr float kLn2Bf16 = 0.69140625f;  // ln 2 rounded to bf16
constexpr int kQTile = 64, kWarps = 4, kThreads = kWarps * 32, kMaxHead = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long row_stride, head_stride;      // elements between grid z rows / y heads of q, k, v
  long long o_row_stride, o_head_stride;  // the same for o
  int ld, ld_o;                           // elements between frames
  int t_len;                              // frames: queries and keys
  int n_keys;                             // keys walked (kOnline: t_len padded)
  int hd;                                 // real head width
  float scale;                            // kOnline: multiplies the fp32 logits
  float l_pad;                            // added to l at the end (not kOnline)
  int vec;                                // rows load 16 bytes at a time
};

template <int HDP, int kMode>
struct Shape {
  static constexpr int KT = kMode == kOnline ? 128 : 64;  // keys per tile
  static constexpr int LDT = HDP + 4;                     // Q / K / V tiles
  static constexpr int LDS = (KT > HDP ? KT : HDP) + 4;   // S, then P in place
  static constexpr int LDO = HDP + 4;                     // the accumulator
  static constexpr size_t kQ = (size_t)kQTile * LDT * sizeof(float);
  static constexpr size_t kKV = (size_t)KT * LDT * sizeof(float);  // K, then V, of one tile
  static constexpr size_t kS = (size_t)kWarps * 16 * LDS * sizeof(float);
  static constexpr size_t kAcc = (size_t)kWarps * 16 * LDO * sizeof(float);
  static constexpr size_t kSmem = kQ + kKV + kS + kAcc;
  static_assert(HDP % 16 == 0 && HDP <= kMaxHead, "head width");
  static_assert(kSmem <= 232448, "shared memory");
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// rows [r0, r0 + n_rows) of one head (frame stride ld, width hd) into an
// (n_rows, LDT) tile of HDP columns; rows >= t_len and columns >= hd are zeros
template <int HDP, int LDT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n_rows, int t_len, int ld,
                                          int hd, bool vec, int tid) {
  if (vec) {  // hd, ld and the head offsets are multiples of 16 bytes
    constexpr int kPerRow = HDP / 4;
    for (int idx = tid; idx < n_rows * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow, c = (idx % kPerRow) * 4;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < t_len && c < hd) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c);
      *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
    }
  } else {
    for (int idx = tid; idx < n_rows * HDP; idx += kThreads) {
      const int r = idx / HDP, c = idx % HDP;
      float val = 0.f;
      if (r0 + r < t_len && c < hd) val = src[(size_t)(r0 + r) * ld + c];
      dst[r * LDT + c] = val;
    }
  }
}

// the warp's 16 x KT logits of the key tile in shared memory into s (ld
// LDS); lane: query row lane / 2, keys (lane % 2) KT/2 .. + KT/2
template <int HDP, int KT, int LDT, int LDS>
__device__ __forceinline__ void warp_logits(float* s, const float* q, const float* k, int lane) {
  const int r = lane >> 1, c0 = (lane & 1) * (KT / 2);
  const float4* qr = reinterpret_cast<const float4*>(q + r * LDT);
  for (int c = c0; c < c0 + KT / 2; ++c) {
    const float4* kr = reinterpret_cast<const float4*>(k + c * LDT);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HDP / 4; ++i) {
      const float4 a = qr[i], b = kr[i];
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
    s[r * LDS + c] = acc;
  }
}

// o (16 x HDP, fp32, ld LDO) = P (16 x KT fp32, ld LDS) V for the lane's
// row and half of the columns, combined into the accumulator:
// acc = acc * keep + o * add
template <int HDP, int KT, int LDT, int LDS, int LDO>
__device__ __forceinline__ void simt_pv(float* acc, const float* p, const float* v, int lane,
                                        float keep, float add) {
  const int r = lane >> 1, c0 = (lane & 1) * (HDP / 2);
  for (int c = c0; c < c0 + HDP / 2; c += 4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < KT; ++j) {
      const float pv = p[r * LDS + j];
      const float4 vv = *reinterpret_cast<const float4*>(v + j * LDT + c);
      o.x = fmaf(pv, vv.x, o.x);
      o.y = fmaf(pv, vv.y, o.y);
      o.z = fmaf(pv, vv.z, o.z);
      o.w = fmaf(pv, vv.w, o.w);
    }
    float4* a = reinterpret_cast<float4*>(acc + r * LDO + c);
    float4 cur = *a;
    cur.x = cur.x * keep + o.x * add;
    cur.y = cur.y * keep + o.y * add;
    cur.z = cur.z * keep + o.z * add;
    cur.w = cur.w * keep + o.w * add;
    *a = cur;
  }
}

// The block of queries blockIdx.x * 64 .. + 64 of head blockIdx.y of row
// blockIdx.z, with Shape::kSmem bytes of dynamic shared memory.
template <int HDP, int kMode>
__global__ void __launch_bounds__(kThreads) attention_kernel(Args a) {
  using Sh = Shape<HDP, kMode>;
  constexpr int KT = Sh::KT, LDT = Sh::LDT, LDS = Sh::LDS, LDO = Sh::LDO;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  float* qs = reinterpret_cast<float*>(base);
  float* kv = reinterpret_cast<float*>(base + Sh::kQ);
  float* s_all = reinterpret_cast<float*>(base + Sh::kQ + Sh::kKV);
  float* acc_all = reinterpret_cast<float*>(base + Sh::kQ + Sh::kKV + Sh::kS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, row = blockIdx.z;
  const long long off = row * a.row_stride + h * a.head_stride;
  const float* qb = static_cast<const float*>(a.q) + off;
  const float* kb = static_cast<const float*>(a.k) + off;
  const float* vb = static_cast<const float*>(a.v) + off;
  const int t_len = a.t_len, ld = a.ld, hd = a.hd;
  const bool vec = a.vec != 0;
  float* s = s_all + warp * 16 * LDS;
  float* acc_s = acc_all + warp * 16 * LDO;
  const float* qw = qs + warp * 16 * LDT;
  // lane -> (query row r of the warp's 16, key columns c0 .. c0 + KT/2 and
  // accumulator columns oc0 .. oc0 + HDP/2)
  const int r = lane >> 1, c0 = (lane & 1) * (KT / 2), oc0 = (lane & 1) * (HDP / 2);
  const int n_ktiles = (a.n_keys + KT - 1) / KT;
  const float kNegInf = -__int_as_float(0x7f800000);

  load_rows<HDP, LDT>(qs, qb, q0, kQTile, t_len, ld, hd, vec, tid);
  for (int c = oc0; c < oc0 + HDP / 2; ++c) acc_s[r * LDO + c] = 0.f;

  float row_max = 0.f;
  if constexpr (kMode == kExact) {  // pass 1: the row max over every valid key
    row_max = kNegInf;
    for (int kt = 0; kt < n_ktiles; ++kt) {
      __syncthreads();
      load_rows<HDP, LDT>(kv, kb, kt * KT, KT, t_len, ld, hd, vec, tid);
      __syncthreads();
      warp_logits<HDP, KT, LDT, LDS>(s, qw, kv, lane);
      __syncwarp();
      for (int c = 0; c < KT / 2; ++c) {
        if (kt * KT + c0 + c < t_len) row_max = fmaxf(row_max, s[r * LDS + c0 + c]);
      }
      __syncwarp();
    }
    row_max = fmaxf(row_max, __shfl_xor_sync(fsem::kFullMask, row_max, 1));
  }

  float l = 0.f;          // row sum (the lane's half until the end; kOnline: the row's)
  float m_run = kNegInf;  // kOnline: running max
  for (int kt = 0; kt < n_ktiles; ++kt) {
    __syncthreads();
    load_rows<HDP, LDT>(kv, kb, kt * KT, KT, t_len, ld, hd, vec, tid);
    __syncthreads();
    warp_logits<HDP, KT, LDT, LDS>(s, qw, kv, lane);
    __syncwarp();

    float m_next = 0.f, keep = 1.f, add = 1.f;
    if constexpr (kMode == kOnline) {
      float m_cur = kNegInf;
      for (int c = 0; c < KT / 2; ++c) {
        if (kt * KT + c0 + c < t_len) m_cur = fmaxf(m_cur, s[r * LDS + c0 + c] * a.scale);
      }
      m_cur = fmaxf(m_cur, __shfl_xor_sync(fsem::kFullMask, m_cur, 1));
      m_next = fmaxf(m_run, m_cur);
    }
    float l_tile = 0.f;
    for (int c = 0; c < KT / 2; ++c) {
      const float sv = s[r * LDS + c0 + c];
      float pv = 0.f;
      if (kt * KT + c0 + c < t_len) {
        if constexpr (kMode == kOnline) {
          pv = expf(sv * a.scale - m_next);
        } else if constexpr (kMode == kExact) {
          pv = expf(sv - row_max);
        } else {
          const float cl = fminf(fmaxf(sv, -100.f), 60.f);
          if constexpr (kMode == kExp2Bf16) {
            pv = bf16_round(expf(bf16_round(bf16_round(cl) * kLn2Bf16)));
          } else {
            pv = exp2f(cl);
          }
        }
      }
      l_tile += pv;
      s[r * LDS + c0 + c] = pv;  // P in place
    }
    if constexpr (kMode == kOnline) {
      l_tile += __shfl_xor_sync(fsem::kFullMask, l_tile, 1);
      const float l_corr = expf(m_run - m_next) * l;
      const float l_next = l_tile + l_corr;
      const float inv = l_next == 0.f ? 1.f : 1.f / l_next;
      keep = l_corr * inv;
      add = inv;
      m_run = m_next;
      l = l_next;
    } else {
      l += l_tile;
    }
    __syncwarp();

    __syncthreads();  // V into K's tile once every warp has its logits
    load_rows<HDP, LDT>(kv, vb, kt * KT, KT, t_len, ld, hd, vec, tid);
    __syncthreads();
    simt_pv<HDP, KT, LDT, LDS, LDO>(acc_s, s, kv, lane, keep, add);
    __syncwarp();
  }

  // the output: acc (kOnline, normalised already) or ctx / l
  float denom = 1.f;
  if constexpr (kMode != kOnline) {
    l += __shfl_xor_sync(fsem::kFullMask, l, 1);
    denom = l + a.l_pad;
  }
  const int q = q0 + warp * 16 + r;
  if (q < t_len) {
    float* out = static_cast<float*>(a.o) + row * a.o_row_stride + h * a.o_head_stride + (size_t)q * a.ld_o;
    for (int c = oc0; c < oc0 + HDP / 2 && c < hd; ++c) {
      const float val = acc_s[r * LDO + c];
      out[c] = kMode == kOnline ? val : val / denom;
    }
  }
}

template <int HDP, int kMode>
cudaError_t launch(const Args& a, int heads, int rows, cudaStream_t stream) {
  constexpr size_t smem = Shape<HDP, kMode>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<HDP, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + kQTile - 1) / kQTile, heads, rows);
  attention_kernel<HDP, kMode><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation for hd padded to a multiple of 16; wider than 128 is refused
template <int kMode>
cudaError_t launch_any_width(const Args& a, int heads, int rows, cudaStream_t stream) {
  switch ((a.hd + 15) / 16) {
    case 1: return launch<16, kMode>(a, heads, rows, stream);
    case 2: return launch<32, kMode>(a, heads, rows, stream);
    case 3: return launch<48, kMode>(a, heads, rows, stream);
    case 4: return launch<64, kMode>(a, heads, rows, stream);
    case 5: return launch<80, kMode>(a, heads, rows, stream);
    case 6: return launch<96, kMode>(a, heads, rows, stream);
    case 7: return launch<112, kMode>(a, heads, rows, stream);
    case 8: return launch<128, kMode>(a, heads, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A9 / A15 layout: q, k, v, o contiguous (batch, heads, t_len, head_dim)
inline Args bhtd_args(const void* q, const void* k, const void* v, void* o, int heads, int t_len, int n_keys,
                      int head_dim, float scale, float l_pad) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.head_stride = a.o_head_stride = (long long)t_len * head_dim;
  a.row_stride = a.o_row_stride = a.head_stride * heads;
  a.ld = a.ld_o = head_dim;
  a.t_len = t_len;
  a.n_keys = n_keys;
  a.hd = head_dim;
  a.scale = scale;
  a.l_pad = l_pad;
  a.vec = head_dim % 4 == 0;
  return a;
}

// the instantiation for a runtime softmax mode
inline cudaError_t launch_mode(const Args& a, int mode, int heads, int rows, cudaStream_t stream) {
  switch (mode) {
    case kExp2: return launch_any_width<kExp2>(a, heads, rows, stream);
    case kExp2Bf16: return launch_any_width<kExp2Bf16>(a, heads, rows, stream);
    case kExact: return launch_any_width<kExact>(a, heads, rows, stream);
    case kOnline: return launch_any_width<kOnline>(a, heads, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace attn
}  // namespace
