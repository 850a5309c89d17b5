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
//   * split-K (flash-decoding): the grid is (slot x kv head, split). A block
//     holds the G query rows of one kv head's group, so a K/V row is read
//     once for all G queries (GQA-native), and walks one contiguous run of
//     `per` logical blocks of its slot's block table, clipped to seq_len; a
//     block whose run starts at or past seq_len returns at once. The host
//     picks the split count from the shapes alone (B * Hkv, Bps, bs and the
//     SM count; never seq_lens, so a decode tick does not wait on the
//     card): a few slots with long contexts spread over many SMs instead of
//     being walked by one block each;
//   * within a block each of the 8 warps takes 4 positions at a time
//     (independent loads for memory-level parallelism) and keeps its own m,
//     l and acc in f32 registers, lanes splitting D. The warps' states are
//     merged once through shared memory into the block's (m, l, acc[G][D]);
//   * the block writes that partial state, in f32, to a workspace the
//     wrapper allocates, and paged_combine_kernel merges the splits that
//     cover [0, seq_len) with the same formula (two launches on the
//     caller's stream, one after the other);
//   * variants timed on the H100 and not kept: the last block to arrive
//     doing the combine (an atomic counter, one launch), 16-byte loads, 2
//     positions a warp step, and launch bounds that give ptxas the
//     registers to drop the small spill it leaves here; each was slower or
//     no faster. A programmatic dependent launch of the combine saved about
//     a microsecond a call, which no serving metric can see;
//   * positions past seq_len are never visited. That gives what masking them
//     gives, except for a row with no live position at all: it comes out as
//     zeros (finite), where the TPU kernel averages the masked garbage.
//     Callers ignore such rows;
//   * a sliding window (window > 0) keeps positions [seq_len - window,
//     seq_len): the query sits at seq_len - 1 and sees a key when
//     qpos - kpos < window, the model's cached mask. Positions below the
//     bound are never visited either: a block whose run ends at or below
//     it returns at once, and the combine starts at the first split that
//     reaches past it. The split count does not depend on the window;
//   * int8 pools are dequantized in registers as q8 * scale, bf16 widened to
//     f32; all arithmetic is f32. Masked positions (invalid in valid_pool,
//     or an out-of-range physical id) contribute nothing.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ops/paged_decode.py); the launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launches.

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

// The first position a query at seq_len - 1 sees: 0 without a window.
__device__ __forceinline__ int window_lo(int len, int window) {
  return window > 0 ? max(0, len - window) : 0;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// q: (B, Hkv, G, D); pools: (N, bs, Hkv, D); scales: (N, bs, Hkv) or
// null; valid: (N, bs) bytes or null; tables: (B, Bps) int32; seq_lens: (B,).
// part: acc (B * Hkv, splits, G, D), then (m, l) (B * Hkv, splits, G, 2),
// f32. Block (x, y) walks positions [y * per * bs, (y + 1) * per * bs) of
// slot x / Hkv, clipped to [window_lo(len, window), len).
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                    const KT* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const uint8_t* __restrict__ valid,
                    const int32_t* __restrict__ tables,
                    const int32_t* __restrict__ seq_lens,
                    float* __restrict__ part, int Hkv, int G, int N, int bs,
                    int Bps, int per, int window, float sm_scale) {
  constexpr int VEC = D / 32;
  __shared__ float sh_m[kWarps][kMaxG];
  __shared__ float sh_l[kWarps][kMaxG];
  __shared__ float sh_acc[kWarps][kMaxG][D];

  const int bh = blockIdx.x, b = bh / Hkv, h = bh - b * Hkv;
  const int split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const int len = min(max(seq_lens[b], 0), Bps * bs);
  const int lo = window_lo(len, window);
  const int p1 = min(len, (split + 1) * per * bs);
  // the combine reads no split wholly past len or below lo
  if (split * per * bs >= len || p1 <= lo) return;
  const int p0 = max(split * per * bs, lo);

  const QT* qb = q + static_cast<size_t>(bh) * G * D;
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

  const int32_t* tb = tables + static_cast<size_t>(b) * Bps;
  for (int base = p0 + warp * kUnroll; base < p1; base += kWarps * kUnroll) {
    float kf[kUnroll][VEC], vf[kUnroll][VEC];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      live[u] = false;
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[u][e] = vf[u][e] = 0.f;
      if (t < p1) {
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
  const size_t cell = static_cast<size_t>(bh) * splits + split;
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
    part[cell * G * D + i] = num;
    if (d == 0) {
      float* ml = part + static_cast<size_t>(gridDim.x) * splits * G * D +
                  (cell * G + g) * 2;
      ml[0] = mx;
      ml[1] = den;
    }
  }
}

// out[b, h] from the partial states of the splits of (b, h) that cover
// [window_lo, seq_len), merged as the warps' states are; no split: zeros.
// One thread an output element.
template <typename QT>
__global__ void paged_combine_kernel(const float* __restrict__ part,
                                     const int32_t* __restrict__ seq_lens,
                                     QT* __restrict__ out, int Hkv, int G,
                                     int D, int bs, int Bps, int per,
                                     int splits, int window) {
  const int bh = blockIdx.x, b = bh / Hkv;
  const int i = threadIdx.x, g = i / D, d = i - g * D;
  const int len = min(max(seq_lens[b], 0), Bps * bs);
  const int first = window_lo(len, window) / (per * bs);
  const int live = (len + per * bs - 1) / (per * bs);
  const float* acc = part + static_cast<size_t>(bh) * splits * G * D;
  const float* ml = part + static_cast<size_t>(gridDim.x) * splits * G * D +
                    static_cast<size_t>(bh) * splits * G * 2;
  float mx = kNegInf;
  for (int sp = first; sp < live; ++sp) mx = fmaxf(mx, ml[(sp * G + g) * 2]);
  float den = 0.f, num = 0.f;
  for (int sp = first; sp < live; ++sp) {
    const float c = expf(ml[(sp * G + g) * 2] - mx);
    den += ml[(sp * G + g) * 2 + 1] * c;
    num += acc[(sp * G + g) * D + d] * c;
  }
  store(out + static_cast<size_t>(bh) * G * D + i, num / fmaxf(den, 1e-30f));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *valid, *tables, *lens;
  void *out, *part;
  int B, Hkv, G, D, N, bs, Bps, splits, per, window;
  float sm_scale;
};

template <typename QT, typename KT, int D>
cudaError_t launch_d(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.Hkv, a.splits);
  paged_decode_kernel<QT, KT, D><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const uint8_t*>(a.valid),
      static_cast<const int32_t*>(a.tables),
      static_cast<const int32_t*>(a.lens), static_cast<float*>(a.part), a.Hkv,
      a.G, a.N, a.bs, a.Bps, a.per, a.window, a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<QT><<<a.B * a.Hkv, a.G * a.D, 0, stream>>>(
      static_cast<const float*>(a.part), static_cast<const int32_t*>(a.lens),
      static_cast<QT*>(a.out), a.Hkv, a.G, a.D, a.bs, a.Bps, a.per, a.splits,
      a.window);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t launch_typed(const Args& a, cudaStream_t stream) {
  switch (a.D) {
    case 32: return launch_d<QT, KT, 32>(a, stream);
    case 64: return launch_d<QT, KT, 64>(a, stream);
    case 128: return launch_d<QT, KT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t launch_q(int kv_dtype, const Args& a, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32: return launch_typed<QT, float>(a, stream);
    case kBF16: return launch_typed<QT, __nv_bfloat16>(a, stream);
    case kI8: return launch_typed<QT, int8_t>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* valid,
                                   const void* tables, const void* seq_lens,
                                   void* out, void* part, int B, int Hkv,
                                   int G, int D, int N, int bs, int Bps,
                                   int splits, int per, float sm_scale,
                                   int window, int q_dtype, int kv_dtype,
                                   void* stream) {
  // splits runs of per blocks cover the table, none of them empty
  if (B < 1 || Hkv < 1 || G < 1 || G > kMaxG || N < 1 || bs < 1 || Bps < 1 ||
      per < 1 || splits < 1 || splits > 65535 || splits * per < Bps ||
      (splits - 1) * per >= Bps || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, valid, tables,
               seq_lens, out, part, B, Hkv, G, D, N, bs, Bps, splits, per,
               window, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (q_dtype) {
    case kF32: err = launch_q<float>(kv_dtype, a, s); break;
    case kBF16: err = launch_q<__nv_bfloat16>(kv_dtype, a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
