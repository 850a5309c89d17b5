// Paged flash decode for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_deep_learning_tpu/ops/paged_decode_pallas.py
// ::_decode_kernel (launched by paged_flash_decode): one decode query per slot
// attends straight off the paged KV pools through the slot's block table, with
// an online softmax, so no slot's logical cache is ever gathered into a copy.
//
// Bound: bytes. Per token the kernel reads each live K/V row once (2 * Hkv * D
// elements per position) and does 4 * G flops per element read, far below the
// ~20 flops/byte at which the card's f32 units (67 TFLOP/s) rather than its
// HBM (3.35 TB/s) would limit it. So the design aims at keeping every SM's
// loads in flight and reading nothing twice:
//   * one thread block per (slot, kv head), holding the G query rows of that
//     head's group, so a K/V row is read once for all G queries (GQA-native);
//   * the block reads its own row of the block table and visits only the
//     ceil(seq_len / bs) logical blocks that hold live positions. Skipping the
//     blocks past seq_len gives what masking them gives, except for a row with
//     no live position at all: it comes out as zeros (finite), where the TPU
//     kernel averages the masked garbage. Callers ignore such rows;
//   * each of the 8 warps takes 4 positions at a time (independent loads for
//     memory-level parallelism) and keeps its own m, l and acc in f32
//     registers, lanes splitting D. The warps' partial softmax states are
//     merged once at the end through shared memory;
//   * int8 pools are dequantized in registers as q8 * scale, bf16 widened to
//     f32; all arithmetic is f32. Masked positions (past seq_len, invalid in
//     valid_pool, or an out-of-range physical id) contribute nothing.
// The next design step is split-K (flash-decoding): with few slots and long
// contexts B * Hkv blocks do not fill 132 SMs, so the position loop should be
// cut across blocks and reduced in a second pass.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ops/paged_decode.py); the launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernel
constexpr int kWarps = 8;
constexpr int kUnroll = 4;         // positions per warp per step
constexpr int kMaxG = 8;           // query heads per kv head

enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// q and out: (B, Hkv, G, D); pools: (N, bs, Hkv, D); scales: (N, bs, Hkv) or
// null; valid: (N, bs) bytes or null; tables: (B, Bps) int32; seq_lens: (B,).
template <typename QT, typename KT, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ seq_lens,
                    QT* __restrict__ out, int Hkv, int G, int N, int bs,
                    int Bps, float sm_scale) {
  constexpr int D = VEC * 32;
  __shared__ float sh_m[kWarps][kMaxG];
  __shared__ float sh_l[kWarps][kMaxG];
  __shared__ float sh_acc[kWarps][kMaxG][D];

  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const QT* qb = q + (static_cast<size_t>(b) * Hkv + h) * G * D;
  float qr[kMaxG][VEC];
  float m[kMaxG], l[kMaxG], acc[kMaxG][VEC];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] = g < G ? to_f32(qb[g * D + lane * VEC + e]) : 0.f;
      acc[g][e] = 0.f;
    }
  }

  int len = seq_lens[b];
  len = len < 0 ? 0 : (len > Bps * bs ? Bps * bs : len);
  const int32_t* tb = tables + static_cast<size_t>(b) * Bps;

  for (int base = warp * kUnroll; base < len; base += kWarps * kUnroll) {
    float kf[kUnroll][VEC], vf[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      live[u] = false;
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (t < len) {
        const int j = t / bs;
        const int off = t - j * bs;
        const int p = tb[j];
        if (p >= 0 && p < N &&
            (valid == nullptr || valid[static_cast<size_t>(p) * bs + off])) {
          live[u] = true;
          const size_t row = (static_cast<size_t>(p) * bs + off) * Hkv + h;
          const KT* kr = k_pool + row * D + lane * VEC;
          const KT* vr = v_pool + row * D + lane * VEC;
          const float ks = k_scale != nullptr ? k_scale[row] : 1.f;
          const float vs = v_scale != nullptr ? v_scale[row] : 1.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            kf[u][e] = to_f32(kr[e]) * ks;
            vf[u][e] = to_f32(vr[e]) * vs;
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d += qr[g][e] * kf[u][e];
          s[u] = d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        }
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = live[u] ? s[u] * sm_scale : kNegInf;
          mx = fmaxf(mx, s[u]);
        }
        const float corr = expf(m[g] - mx);
        float p[kUnroll];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = live[u] ? expf(s[u] - mx) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * corr + psum;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float a = acc[g][e] * corr;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a += p[u] * vf[u][e];
          acc[g][e] = a;
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (lane == 0) {
        sh_m[warp][g] = m[g];
        sh_l[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) sh_acc[warp][g][lane * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();
  QT* ob = out + (static_cast<size_t>(b) * Hkv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sh_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sh_m[w][g] - mx);
      den += sh_l[w][g] * c;
      num += sh_acc[w][g][d] * c;
    }
    store(ob + i, num / fmaxf(den, 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* valid,
                         const void* tables, const void* lens, void* out,
                         int B, int Hkv, int G, int D, int N, int bs, int Bps,
                         float sm_scale, cudaStream_t stream) {
  const dim3 grid(B * Hkv), block(kWarps * 32);
#define PAGED_DECODE_LAUNCH(VEC)                                            \
  paged_decode_kernel<QT, KT, VEC><<<grid, block, 0, stream>>>(             \
      static_cast<const QT*>(q), static_cast<const KT*>(k),                 \
      static_cast<const KT*>(v), static_cast<const float*>(ks),             \
      static_cast<const float*>(vs), static_cast<const uint8_t*>(valid),    \
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(lens), \
      static_cast<QT*>(out), Hkv, G, N, bs, Bps, sm_scale)
  switch (D) {
    case 32: PAGED_DECODE_LAUNCH(1); break;
    case 64: PAGED_DECODE_LAUNCH(2); break;
    case 128: PAGED_DECODE_LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_DECODE_LAUNCH
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_q(int kv_dtype, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs,
                     const void* valid, const void* tables, const void* lens,
                     void* out, int B, int Hkv, int G, int D, int N, int bs,
                     int Bps, float sm_scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch_typed<QT, float>(q, k, v, ks, vs, valid, tables, lens,
                                     out, B, Hkv, G, D, N, bs, Bps, sm_scale,
                                     stream);
    case kBF16:
      return launch_typed<QT, __nv_bfloat16>(q, k, v, ks, vs, valid, tables,
                                             lens, out, B, Hkv, G, D, N, bs,
                                             Bps, sm_scale, stream);
    case kI8:
      return launch_typed<QT, int8_t>(q, k, v, ks, vs, valid, tables, lens,
                                      out, B, Hkv, G, D, N, bs, Bps,
                                      sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* valid,
                                   const void* tables, const void* seq_lens,
                                   void* out, int B, int Hkv, int G, int D,
                                   int N, int bs, int Bps, float sm_scale,
                                   int q_dtype, int kv_dtype, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || N < 1 || bs < 1 || Bps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case kF32:
      err = launch_q<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale,
                            valid, tables, seq_lens, out, B, Hkv, G, D, N, bs,
                            Bps, sm_scale, s);
      break;
    case kBF16:
      err = launch_q<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale,
                                    v_scale, valid, tables, seq_lens, out, B,
                                    Hkv, G, D, N, bs, Bps, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
