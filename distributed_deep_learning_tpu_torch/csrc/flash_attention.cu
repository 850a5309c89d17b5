// Flash attention, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the three TPU kernels of
// distributed_deep_learning_tpu/ops/attention_pallas.py:
//   flash_fwd_kernel <- _fwd_kernel (launched by _flash_fwd)
//   flash_dq_kernel  <- _dq_kernel  (launched by _flash_bwd, first pallas_call)
//   flash_dkv_kernel <- _dkv_kernel (launched by _flash_bwd, second pallas_call)
// They compute what those kernels compute, with the same numerics: masked
// logits are -1e30, the forward keeps an online softmax (m, l, acc) in f32 and
// emits O = acc / max(l, 1e-30) and LSE = max(m, -1e20) + log(max(l, 1e-30)),
// the backward recomputes p = exp(s - LSE) and ds = p * (dO.V^T - delta) *
// scale with delta = rowsum(dO * O) computed by the caller. Together these give
// a fully padded row exactly zero gradients. Causal masking is top-left (query
// and key positions both count from 0, q_pos >= k_pos), a sliding window keeps
// q_pos - k_pos < window, and key_valid masks keys per batch row.
//
// Layouts are the model's own, so the wrapper copies nothing: q, O, dO, dQ are
// (B, Tq, H, D); k, v, dK, dV are (B, Tk, Hkv, D) with H a multiple of Hkv
// (GQA: query head h reads kv head h / (H / Hkv), no expanded copy exists);
// key_valid is (B, Tk) bytes or null; LSE and delta are (B, H, Tq) f32.
// Inputs are f32 or bf16; every product and sum is f32, outputs are written in
// the input type.
//
// Bound: operations. At the training shape (B 4, H 12, T 2048, D 64, causal)
// the forward does 2*T^2*D flops per (batch, head), dQ 3*T^2*D and dK/dV
// 4*T^2*D, over ~25 MB of tensors each: ~1000 flops per byte, far above the
// card's ~20 (f32) or ~300 (bf16) flops per byte of HBM. The TPU kernels
// snapped their blocks to divisors of T and ran whole (T, D) K/V rows from
// VMEM; here a thread block owns 64 rows and streams the other side's rows
// through shared memory in tiles, masking the ragged tail instead of snapping:
//   * forward and dQ: one block per (64 query rows, batch * head); the key loop
//     stops at the causal diagonal and starts at the window's lower bound;
//   * dK/dV: one block per (64 key rows, batch * kv head); the query loop starts
//     at the diagonal and stops at the window's upper bound, and the block loops
//     over the query heads of its GQA group, so the group sum is taken in f32
//     registers and dK/dV are written once;
//   * a row's D features are split over D/32 threads in the forward and D/16
//     in the backward (one for small D), each holding its part of q, dO, k or
//     v and of the accumulators in registers;
//     dot products are summed over those lanes with shuffles; shared-memory rows
//     are padded so that the parts one load phase reads fall in different banks.
// All arithmetic runs on the f32 units (67 TFLOP/s), not the tensor cores. The
// next design step is bf16 tiles on the tensor cores: mma.sync first, then
// wgmma with TMA-fed shared-memory stages.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (see ops/attention.py); each launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the TPU kernels
constexpr int kRows = 64;          // rows a block owns (query or key rows)
constexpr int kChunk = 8;          // streamed rows scored per inner step

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Shape {
  int B, H, Hkv, Tq, Tk;
  float scale;
  int causal;
  int window;  // <= 0: no sliding window
};

// A row's D features over TPR = D / DT threads. The forward holds two
// row-sized arrays per thread (q, acc) and takes DT = 32; dQ holds three and
// dK/dV four, so they take DT = 16 to stay clear of register spills.
template <int D_, int DT_>
struct Tile {
  static constexpr int D = D_;
  static constexpr int DT = D < DT_ ? D : DT_;  // features a thread holds
  static constexpr int TPR = D / DT;            // threads per row
  static constexpr int THREADS = kRows * TPR;
  static constexpr int PART = DT + 4;         // padded part in shared memory
  static constexpr int SROW = TPR * PART;
  static constexpr int BT = D == 128 ? 32 : 64;  // streamed rows per tile
};

__device__ __forceinline__ bool in_band(const Shape& s, int qi, int kj) {
  if (!s.causal) return true;
  return qi >= kj && (s.window <= 0 || qi - kj < s.window);
}

template <int D>
using FwdTile = Tile<D, 32>;
template <int D>
using BwdTile = Tile<D, 16>;

// rows [t0, t0 + BT) of head hn of a (B, T, Hn, D) tensor, as f32, zero past T
template <typename L, typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int b,
                                          int hn, int Hn, int T, int t0) {
  constexpr int D = L::D;
  for (int i = threadIdx.x; i < L::BT * D; i += blockDim.x) {
    const int j = i / D, d = i - j * D, t = t0 + j;
    float x = 0.f;
    if (t < T) x = to_f32(src[((static_cast<size_t>(b) * T + t) * Hn + hn) * D + d]);
    dst[j * L::SROW + (d / L::DT) * L::PART + d % L::DT] = x;
  }
}

template <int DT, typename E>
__device__ __forceinline__ void load_row(float (&r)[DT], const E* src,
                                         bool ok) {
#pragma unroll
  for (int e = 0; e < DT; ++e) r[e] = ok ? to_f32(src[e]) : 0.f;
}

template <int DT>
__device__ __forceinline__ float dot_part(const float (&r)[DT],
                                          const float* sh) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < DT; e += 4) {
    const float4 x = *reinterpret_cast<const float4*>(sh + e);
    acc = fmaf(r[e], x.x, acc);
    acc = fmaf(r[e + 1], x.y, acc);
    acc = fmaf(r[e + 2], x.z, acc);
    acc = fmaf(r[e + 3], x.w, acc);
  }
  return acc;
}

// acc += sum over the chunk of w[u] * (row j0 + u of the tile), this part
template <typename L>
__device__ __forceinline__ void axpy_chunk(float (&acc)[L::DT],
                                           const float (&w)[kChunk],
                                           const float* tile, int j0,
                                           int part) {
#pragma unroll
  for (int e = 0; e < L::DT; e += 4) {
    float4 a = make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(
          tile + (j0 + u) * L::SROW + part * L::PART + e);
      a.x = fmaf(w[u], x.x, a.x);
      a.y = fmaf(w[u], x.y, a.y);
      a.z = fmaf(w[u], x.z, a.z);
      a.w = fmaf(w[u], x.w, a.w);
    }
    acc[e] = a.x;
    acc[e + 1] = a.y;
    acc[e + 2] = a.z;
    acc[e + 3] = a.w;
  }
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// forward: O and LSE
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(FwdTile<D>::THREADS)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const uint8_t* __restrict__ valid,
                 E* __restrict__ out, float* __restrict__ lse, Shape s) {
  using L = FwdTile<D>;
  __shared__ __align__(16) float ks[L::BT * L::SROW];
  __shared__ __align__(16) float vs[L::BT * L::SROW];

  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int hk = h / (s.H / s.Hkv);
  const int q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / L::TPR, part = threadIdx.x - r * L::TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < s.Tq;
  if (valid != nullptr) valid += static_cast<size_t>(b) * s.Tk;
  const size_t qoff =
      ((static_cast<size_t>(b) * s.Tq + qi) * s.H + h) * D + part * L::DT;

  float qr[L::DT], acc[L::DT];
  load_row<L::DT>(qr, q + qoff, row_ok);
#pragma unroll
  for (int e = 0; e < L::DT; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;

  int lo = 0, hi = s.Tk;
  if (s.causal) {
    hi = min(hi, min(q0 + kRows, s.Tq));  // stop at the diagonal
    if (s.window > 0) lo = max(0, q0 - (s.window - 1));
  }
  for (int t0 = lo - lo % L::BT; t0 < hi; t0 += L::BT) {
    __syncthreads();
    load_tile<L>(ks, k, b, hk, s.Hkv, s.Tk, t0);
    load_tile<L>(vs, v, b, hk, s.Hkv, s.Tk, t0);
    __syncthreads();
    const int n = min(L::BT, hi - t0);
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float sc[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
        sc[u] = row_sum<L::TPR>(
            dot_part<L::DT>(qr, ks + (j0 + u) * L::SROW + part * L::PART));
      float mx = m;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int kj = t0 + j0 + u;
        float x = -INFINITY;  // past the end: no key at all
        if (kj < s.Tk)
          x = (valid == nullptr || valid[kj]) && in_band(s, qi, kj)
                  ? sc[u] * s.scale
                  : kNegInf;
        sc[u] = x;
        mx = fmaxf(mx, x);
      }
      const float corr = expf(m - mx);
      float ps = 0.f;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        sc[u] = expf(sc[u] - mx);
        ps += sc[u];
      }
      l = l * corr + ps;
      m = mx;
#pragma unroll
      for (int e = 0; e < L::DT; ++e) acc[e] *= corr;
      axpy_chunk<L>(acc, sc, vs, j0, part);
    }
  }
  if (row_ok) {
    // a row whose visited keys were all masked averages them: finite, and
    // the clamped LSE makes its backward exactly zero
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int e = 0; e < L::DT; ++e) store(out + qoff + e, acc[e] / den);
    if (part == 0)
      lse[static_cast<size_t>(bh) * s.Tq + qi] = fmaxf(m, -1e20f) + logf(den);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const uint8_t* __restrict__ valid,
                const E* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, E* __restrict__ dq, Shape s) {
  using L = BwdTile<D>;
  __shared__ __align__(16) float ks[L::BT * L::SROW];
  __shared__ __align__(16) float vs[L::BT * L::SROW];

  const int bh = blockIdx.y, b = bh / s.H, h = bh - b * s.H;
  const int hk = h / (s.H / s.Hkv);
  const int q0 = blockIdx.x * kRows;
  const int r = threadIdx.x / L::TPR, part = threadIdx.x - r * L::TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < s.Tq;
  if (valid != nullptr) valid += static_cast<size_t>(b) * s.Tk;
  const size_t qoff =
      ((static_cast<size_t>(b) * s.Tq + qi) * s.H + h) * D + part * L::DT;

  float qr[L::DT], dor[L::DT], acc[L::DT];
  load_row<L::DT>(qr, q + qoff, row_ok);
  load_row<L::DT>(dor, dout + qoff, row_ok);
#pragma unroll
  for (int e = 0; e < L::DT; ++e) acc[e] = 0.f;
  const size_t srow = static_cast<size_t>(bh) * s.Tq + qi;
  const float lse_i = row_ok ? lse[srow] : 0.f;
  const float delta_i = row_ok ? delta[srow] : 0.f;

  int lo = 0, hi = s.Tk;
  if (s.causal) {
    hi = min(hi, min(q0 + kRows, s.Tq));
    if (s.window > 0) lo = max(0, q0 - (s.window - 1));
  }
  for (int t0 = lo - lo % L::BT; t0 < hi; t0 += L::BT) {
    __syncthreads();
    load_tile<L>(ks, k, b, hk, s.Hkv, s.Tk, t0);
    load_tile<L>(vs, v, b, hk, s.Hkv, s.Tk, t0);
    __syncthreads();
    const int n = min(L::BT, hi - t0);
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float sc[kChunk], dp[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int off = (j0 + u) * L::SROW + part * L::PART;
        sc[u] = row_sum<L::TPR>(dot_part<L::DT>(qr, ks + off));
        dp[u] = row_sum<L::TPR>(dot_part<L::DT>(dor, vs + off));
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int kj = t0 + j0 + u;
        float ds = 0.f;
        if (kj < s.Tk) {
          const float x = (valid == nullptr || valid[kj]) && in_band(s, qi, kj)
                              ? sc[u] * s.scale
                              : kNegInf;
          const float p = expf(x - lse_i);
          ds = p * (dp[u] - delta_i) * s.scale;
        }
        sc[u] = ds;
      }
      axpy_chunk<L>(acc, sc, ks, j0, part);
    }
  }
  if (row_ok) {
#pragma unroll
    for (int e = 0; e < L::DT; ++e) store(dq + qoff + e, acc[e]);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV, summed over the GQA group in f32
// ---------------------------------------------------------------------------

template <typename E, int D>
__global__ void __launch_bounds__(BwdTile<D>::THREADS)
flash_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const uint8_t* __restrict__ valid,
                 const E* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dk,
                 E* __restrict__ dv, Shape s) {
  using L = BwdTile<D>;
  __shared__ __align__(16) float qs[L::BT * L::SROW];
  __shared__ __align__(16) float dos[L::BT * L::SROW];
  __shared__ float lses[L::BT];
  __shared__ float deltas[L::BT];

  const int bk = blockIdx.y, b = bk / s.Hkv, hk = bk - b * s.Hkv;
  const int group = s.H / s.Hkv;
  const int k0 = blockIdx.x * kRows;
  const int r = threadIdx.x / L::TPR, part = threadIdx.x - r * L::TPR;
  const int kj = k0 + r;
  const bool row_ok = kj < s.Tk;
  const bool key_ok =
      row_ok && (valid == nullptr || valid[static_cast<size_t>(b) * s.Tk + kj]);
  const size_t koff =
      ((static_cast<size_t>(b) * s.Tk + kj) * s.Hkv + hk) * D + part * L::DT;

  float kr[L::DT], vr[L::DT], dka[L::DT], dva[L::DT];
  load_row<L::DT>(kr, k + koff, row_ok);
  load_row<L::DT>(vr, v + koff, row_ok);
#pragma unroll
  for (int e = 0; e < L::DT; ++e) dka[e] = dva[e] = 0.f;

  int lo = 0, hi = s.Tq;
  if (s.causal) {
    lo = k0;  // queries above the diagonal never see these keys
    if (s.window > 0) hi = min(hi, min(k0 + kRows, s.Tk) - 1 + s.window);
  }
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t lrow = (static_cast<size_t>(b) * s.H + h) * s.Tq;
    for (int i0 = lo - lo % L::BT; i0 < hi; i0 += L::BT) {
      __syncthreads();
      load_tile<L>(qs, q, b, h, s.H, s.Tq, i0);
      load_tile<L>(dos, dout, b, h, s.H, s.Tq, i0);
      for (int i = threadIdx.x; i < L::BT; i += blockDim.x) {
        const bool ok = i0 + i < s.Tq;
        lses[i] = ok ? lse[lrow + i0 + i] : 0.f;
        deltas[i] = ok ? delta[lrow + i0 + i] : 0.f;
      }
      __syncthreads();
      const int n = min(L::BT, hi - i0);
#pragma unroll 1
      for (int j0 = 0; j0 < n; j0 += kChunk) {
        float sc[kChunk], dp[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int off = (j0 + u) * L::SROW + part * L::PART;
          sc[u] = row_sum<L::TPR>(dot_part<L::DT>(kr, qs + off));
          dp[u] = row_sum<L::TPR>(dot_part<L::DT>(vr, dos + off));
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int qi = i0 + j0 + u;
          float p = 0.f, ds = 0.f;
          if (qi < s.Tq) {
            const float x =
                key_ok && in_band(s, qi, kj) ? sc[u] * s.scale : kNegInf;
            p = expf(x - lses[j0 + u]);
            ds = p * (dp[u] - deltas[j0 + u]) * s.scale;
          }
          sc[u] = p;
          dp[u] = ds;
        }
        axpy_chunk<L>(dva, sc, dos, j0, part);
        axpy_chunk<L>(dka, dp, qs, j0, part);
      }
    }
  }
  if (row_ok) {
#pragma unroll
    for (int e = 0; e < L::DT; ++e) {
      store(dk + koff + e, dka[e]);
      store(dv + koff + e, dva[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// dispatch on (dtype, D)
// ---------------------------------------------------------------------------

template <typename E, typename F>
cudaError_t dispatch_d(int D, F& f) {
  switch (D) {
    case 16: return f(E{}, std::integral_constant<int, 16>{});
    case 32: return f(E{}, std::integral_constant<int, 32>{});
    case 64: return f(E{}, std::integral_constant<int, 64>{});
    case 128: return f(E{}, std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int dtype, int D, F f) {
  switch (dtype) {
    case kF32: return dispatch_d<float>(D, f);
    case kBF16: return dispatch_d<__nv_bfloat16>(D, f);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(const Shape& s) {
  return s.B < 1 || s.H < 1 || s.Hkv < 1 || s.H % s.Hkv != 0 || s.Tq < 1 ||
         s.Tk < 1 || s.B * s.H > 65535;
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* valid, void* out, void* lse,
                                int B, int H, int Hkv, int Tq, int Tk, int D,
                                float scale, int causal, int window,
                                int dtype, void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    const dim3 grid((Tq + kRows - 1) / kRows, B * H);
    flash_fwd_kernel<E, DD><<<grid, FwdTile<DD>::THREADS, 0, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const uint8_t*>(valid),
        static_cast<E*>(out), static_cast<float*>(lse), s);
    return cudaGetLastError();
  }));
}

extern "C" int flash_dq_launch(const void* q, const void* k, const void* v,
                               const void* valid, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int Hkv, int Tq, int Tk, int D,
                               float scale, int causal, int window, int dtype,
                               void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    const dim3 grid((Tq + kRows - 1) / kRows, B * H);
    flash_dq_kernel<E, DD><<<grid, BwdTile<DD>::THREADS, 0, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const uint8_t*>(valid),
        static_cast<const E*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<E*>(dq), s);
    return cudaGetLastError();
  }));
}

extern "C" int flash_dkv_launch(const void* q, const void* k, const void* v,
                                const void* valid, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int B, int H, int Hkv, int Tq,
                                int Tk, int D, float scale, int causal,
                                int window, int dtype, void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    const dim3 grid((Tk + kRows - 1) / kRows, B * Hkv);
    flash_dkv_kernel<E, DD><<<grid, BwdTile<DD>::THREADS, 0, st>>>(
        static_cast<const E*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const uint8_t*>(valid),
        static_cast<const E*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<E*>(dk),
        static_cast<E*>(dv), s);
    return cudaGetLastError();
  }));
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
