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
// q_pos - k_pos < window, and key_valid masks keys per batch row. A query
// offset shifts the query positions: q_pos + q_offset >= k_pos and
// q_pos + q_offset - k_pos < window (ring attention's visiting blocks; 0
// everywhere else, which is the TPU kernels' mask). The offset is moved into
// the keys' positions once (a key tile's first key in the forward and dQ, a
// thread's keys in dK/dV), so the per-element mask costs what it did
// without it. Keys past
// the end of a ragged tail get -inf, so they drop out even of a fully masked
// row's average.
//
// Layouts are the model's own, so the wrapper copies nothing: q, O, dO, dQ are
// (B, Tq, H, D); k, v, dK, dV are (B, Tk, Hkv, D) with H a multiple of Hkv
// (GQA: query head h reads kv head h / (H / Hkv), no expanded copy exists);
// key_valid is (B, Tk) bytes or null; LSE and delta are (B, H, Tq) f32.
// Inputs are f32 or bf16 and 16-byte aligned; sums are f32, outputs are
// written in the input type. D is 16, 32, 64 or 128.
//
// Bound: operations. At the training shape (B 4, H 12, T 2048, D 64, causal)
// the forward does 4*D flops per visible (query, key) pair, dQ 6*D and dK/dV
// 8*D, over ~25 MB of tensors each: ~1000 flops per byte, far above the
// card's ~150 (TF32) or ~300 (bf16) flops per byte of HBM. So all three
// kernels run on the tensor cores through warp-level mma.sync:
//   * bf16: m16n8k16 with bf16 operands and f32 sums (989 TFLOP/s peak).
//     P (forward, dV) and dS (dQ, dK) are rounded to bf16 before their
//     products, as the TPU kernel rounds them (p.astype, ds.astype);
//   * f32: 3xTF32, three m16n8k8.tf32 products per tile. Each operand x is
//     split into hi = tf32(x) and lo = tf32(x - hi) and a product is
//     lo.hi + hi.lo + hi.hi in f32 sums (the lo.lo term is below f32's
//     rounding), which keeps f32 accuracy at a third of the 495 TFLOP/s TF32
//     peak. One TF32 pass would keep ~3 decimal digits and change what f32
//     training computes.
// Tile design (all three kernels, 4 warps of 16 rows each, 64 rows a block):
//   * forward: a block owns 64 query rows of one (batch, head); each warp
//     holds its 16 rows of Q as mma A fragments in registers. K/V tiles of 64
//     keys (32 at D 128) stream through a two-stage ring in dynamic shared
//     memory, in the input dtype, by 16-byte cp.async, so the next tile's
//     copy overlaps this tile's math. S = Q.K^T comes out of mma in f32
//     registers; the online softmax runs on those fragments (row max and sum
//     over the 4 lanes of a quad); P is reused from the same registers as the
//     A operand of O += P.V (in f32 with its k index permuted to the
//     accumulator layout, so no shared-memory round trip). The key loop stops
//     at the causal diagonal and starts at the window's lower bound; causal
//     blocks are launched heaviest (last query tile) first;
//   * dQ: the forward's tiling with dK/dV's products, the roles of queries
//     and keys swapped. A block owns 64 query rows of one (batch, head) and
//     keeps their Q and dO in shared memory as mma A operands; K/V tiles of
//     64 keys (32 in f32 and at D 128) stream through the same two-stage
//     cp.async ring.
//     Per tile S = Q.K^T and dP = dO.V^T come out of mma in f32 registers,
//     P = exp2((S.scale - LSE).log2 e) and dS = P.(dP - delta).scale are
//     formed on those fragments, and dS, already in accumulator layout,
//     is the A operand of dQ += dS.K (rounded to bf16 first in bf16). Loop
//     bounds and launch order are the forward's;
//   * a warp whose tile has every (query, key) pair visible (no ragged tail,
//     no key_valid hole, clear of the diagonal and the window's edge) skips
//     the masks (forward and dQ): in bf16 the masks, not the mma, were the
//     longest part;
//   * dK/dV: a block owns 64 key rows of one (batch, kv head) in shared
//     memory and loops over the query heads of its GQA group and their query
//     tiles of 32 rows from the diagonal to the window's upper bound; Q, dO, LSE and delta tiles stream through the cp.async ring.
//     S^T = K.Q^T and dP^T = V.dO^T put key rows on mma's M dimension, so
//     P^T and dS^T sit in accumulator layout and feed dV += P^T.dO and
//     dK += dS^T.Q directly; dK and dV stay in f32 registers across the group
//     and are written once;
//   * shared-memory rows are padded by 16 bytes, which puts the rows a
//     fragment load touches in distinct banks; bf16 B fragments come from
//     ldmatrix (.trans for V, dO and Q on the k side), f32 ones from 32-bit
//     loads.
// The next step is wgmma with TMA-fed stages for the bf16 path.
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
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Shape {
  int B, H, Hkv, Tq, Tk;
  float scale;
  int causal;
  int window;    // <= 0: no sliding window
  int q_offset;  // added to a query's position before the causal mask
};

// qi and kj in one frame: the caller has moved q_offset into one of them
__device__ __forceinline__ bool in_band(const Shape& s, int qi, int kj) {
  if (!s.causal) return true;
  return qi >= kj && (s.window <= 0 || qi - kj < s.window);
}

// ---------------------------------------------------------------------------
// tensor-core building blocks: cp.async, ldmatrix, mma.sync, 3xTF32
// ---------------------------------------------------------------------------

template <typename E>
constexpr bool kF32In = std::is_same<E, float>::value;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a.b for a 16x16 bf16 A (row) and 16x8 bf16 B (col), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b for a 16x8 TF32 A (row) and 8x8 TF32 B (col), f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction (relative error ~2^-22; -inf and large negative x
// give exactly 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (to 2^-22 of x), both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// the same for an A operand that lives across a loop: volatile, so the split
// stays inside the loop instead of being hoisted into twice the registers
// (which made the f32 forward spill)
__device__ __forceinline__ void split_tf32_a(float x, uint32_t& hi,
                                             uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n"
               : "=r"(lo)
               : "f"(x - __uint_as_float(hi)));
}

// 3xTF32: c += a.b with f32 accuracy, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// two f32 as a bf16 pair, the first in the low half (the lower k or column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The mma A fragment for k step kk of a row-major 16 x D operand whose row
// 0 is at x (leading dimension ld): rows g and g + 8, in the input dtype's
// layout (f32: k8 columns t and t + 4; bf16: k16 column pairs 2t and
// 2t + 8). A row that is not ok reads as zeros.
template <typename E>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const E* x,
                                       size_t ld, int kk, int g, int t,
                                       bool ok0 = true, bool ok1 = true) {
  constexpr int KS = kF32In<E> ? 8 : 16, TW = kF32In<E> ? 1 : 2;
  const int c0 = kk * KS + t * TW, c1 = c0 + KS / 2;
  const E* r0 = x + g * ld;
  const E* r1 = r0 + 8 * ld;
  a[0] = ok0 ? ld32(r0 + c0) : 0u;
  a[1] = ok1 ? ld32(r1 + c0) : 0u;
  a[2] = ok0 ? ld32(r0 + c1) : 0u;
  a[3] = ok1 ? ld32(r1 + c1) : 0u;
}

// acc[j] += A . B^T over D for the 16 rows of A (fragments from a_of(kk, a))
// and rows [8j, 8j + 8) of the shared tile bs (row-major, DP a row), j < NT
template <typename E, int D, int DP, int NT, typename AOf>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], AOf a_of,
                                        const E* bs, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kF32In<E>) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t a[4], ah[4], al[4];
      a_of(kk, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_a(__uint_as_float(a[e]), ah[e], al[e]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = bs + (8 * j + g) * DP + 8 * kk + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(p[0], bh0, bl0);
        split_tf32(p[4], bh1, bl1);
        mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
    // ldmatrix x4: matrices (rows 8j.., k 16kk), (8j.., 16kk+8),
    // (8j+8.., 16kk), (8j+8.., 16kk+8) = b0, b1 of n tiles j and j + 1
    const int row = (lane & 7) + ((lane >> 4) << 3);
    const int col = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      a_of(kk, a);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, bs + (8 * j + row) * DP + 16 * kk + col);
        mma_bf16(acc[j], a, r[0], r[1]);
        mma_bf16(acc[j + 1], a, r[2], r[3]);
      }
    }
  }
}

// acc[j] += P . X for P (16 x 8*NT) held in accumulator layout and the
// shared tile xs (8*NT rows of D, row-major, DP a row), n tiles j < D / 8.
// bf16: P is rounded to bf16 and packed into A fragments. f32: the A
// fragment's k slots t and t + 4 take the accumulator's columns 2t and
// 2t + 1, so the B fragment reads rows 2t and 2t + 1 to match.
template <typename E, int D, int DP, int NT>
__device__ __forceinline__ void mma_px(float (&acc)[D / 8][4],
                                       const float (&p)[NT][4], const E* xs,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kF32In<E>) {
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
      const float* x = xs + (8 * kk + 2 * t) * DP + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(x[8 * j], bh0, bl0);
        split_tf32(x[8 * j + DP], bh1, bl1);
        mma_3xtf32(acc[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  } else {
    // ldmatrix x4 .trans: matrices (k 16kk.., n 8j), (16kk+8.., 8j),
    // (16kk.., 8j+8), (16kk+8.., 8j+8) = b0, b1 of n tiles j and j + 1
    const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int col = (lane >> 4) << 3;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        uint32_t r[4];
        ldsm_x4_t(r, xs + (16 * kk + row) * DP + 8 * j + col);
        mma_bf16(acc[j], a, r[0], r[1]);
        mma_bf16(acc[j + 1], a, r[2], r[3]);
      }
    }
  }
}

// rows [t0, t0 + ROWS) of head hn of a (B, T, Hn, D) tensor into a shared
// tile (DP a row) by 16-byte cp.async, zeros past T
template <typename E, int D, int DP, int ROWS>
__device__ __forceinline__ void copy_rows(E* dst, const E* src, int b, int hn,
                                          int Hn, int T, int t0) {
  constexpr int PER = 16 / sizeof(E), CPR = D / PER;  // chunks a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += blockDim.x) {
    const int r = i / CPR, c = i - r * CPR, tt = t0 + r;
    const bool ok = tt < T;
    const E* g =
        ok ? src + ((static_cast<size_t>(b) * T + tt) * Hn + hn) * D + c * PER
           : src;
    cp_async16(dst + r * DP + c * PER, g, ok);
  }
}

// shared-memory plan of the tensor-core kernels: 4 warps, 16 rows each,
// NS rows streamed a tile through a two-stage ring, rows padded 16 bytes
template <typename E, int D, int NS_>
struct TcTile {
  static constexpr int THREADS = 128, STAGES = 2;
  static constexpr int ROWS = THREADS / 2;       // 16 rows a warp
  static constexpr int NS = NS_;                 // streamed rows a tile
  static constexpr int DP = D + 16 / sizeof(E);  // padded row
  static constexpr int TILE = NS * DP;           // elements of one tile
};

// NS by measurement on the H100: 64 keys in the forward (32 at D 128, for
// the registers); 32 queries in dK/dV, whose two score tiles ride on two
// f32 accumulators of D columns
template <typename E, int D>
using FwdTc = TcTile<E, D, D == 128 ? 32 : 64>;
template <typename E, int D>
using DkvTc = TcTile<E, D, 32>;
// dQ, by measurement on the H100: 32 keys a tile in f32 and at D 128, 64
// in bf16
template <typename E, int D>
using DqTc = TcTile<E, D, kF32In<E> || D == 128 ? 32 : 64>;

// ---------------------------------------------------------------------------
// forward: O and LSE
// ---------------------------------------------------------------------------

template <typename E, int D>
constexpr size_t fwd_smem() {
  using L = FwdTc<E, D>;
  return L::STAGES * (2 * L::TILE * sizeof(E) + L::NS);
}

template <typename E, int D>
__global__ void __launch_bounds__(FwdTc<E, D>::THREADS)
flash_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const uint8_t* __restrict__ valid,
                 E* __restrict__ out, float* __restrict__ lse, Shape s) {
  using L = FwdTc<E, D>;
  constexpr int NT = L::NS / 8, KS = D / (kF32In<E> ? 8 : 16);
  extern __shared__ __align__(16) unsigned char smem[];
  E* kv_s = reinterpret_cast<E*>(smem);  // stage st: K at 2*st, V at 2*st+1
  uint8_t* mask_s = smem + L::STAGES * 2 * L::TILE * sizeof(E);

  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int hk = h / (s.H / s.Hkv);
  // causal: the last query tiles see the most keys; launch them first
  const int qt = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * L::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  if (valid != nullptr) valid += static_cast<size_t>(b) * s.Tk;

  // this warp's 16 query rows as A fragments, loaded once
  uint32_t qa[KS][4];
  {
    const size_t ld = static_cast<size_t>(s.H) * D;
    const E* qw = q + ((static_cast<size_t>(b) * s.Tq + q0 + warp * 16) *
                           s.H + h) * D;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      frag_a<E>(qa[kk], qw, ld, kk, g, t, r0 < s.Tq, r1 < s.Tq);
  }

  int lo = 0, hi = s.Tk;
  if (s.causal) {  // stop at the diagonal
    hi = min(hi, max(0, min(q0 + L::ROWS, s.Tq) + s.q_offset));
    if (s.window > 0)
      lo = max(0, q0 + s.q_offset - (s.window - 1));
  }
  const int first = lo / L::NS;
  const int n = max(0, (hi + L::NS - 1) / L::NS - first);

  auto issue = [&](int i) {
    const int st = i % L::STAGES, t0 = (first + i) * L::NS;
    E* ks = kv_s + 2 * st * L::TILE;
    copy_rows<E, D, L::DP, L::NS>(ks, k, b, hk, s.Hkv, s.Tk, t0);
    copy_rows<E, D, L::DP, L::NS>(ks + L::TILE, v, b, hk, s.Hkv, s.Tk, t0);
    // 0: past the end (-inf), 1: masked by key_valid (-1e30), 2: a key
    bool all_keys = true;
    for (int j = threadIdx.x; j < L::NS; j += blockDim.x) {
      const int kj = t0 + j;
      const uint8_t code =
          kj >= s.Tk ? 0 : (valid == nullptr || valid[kj]) ? 2 : 1;
      mask_s[st * L::NS + j] = code;
      all_keys = all_keys && code == 2;
    }
    return all_keys;
  };

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's part
  const int qw0 = q0 + warp * 16;  // this warp's first row

  // all_keys: the tile holds no masked or missing key (then a warp whose
  // rows see every key of the tile skips the masks)
  bool all_keys = n > 0 ? issue(0) : true;
  cp_async_commit();
  all_keys = __syncthreads_and(all_keys);
  for (int i = 0; i < n; ++i) {
    const bool next = i + 1 < n ? issue(i + 1) : true;
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed
    const bool all_next = __syncthreads_and(next);
    const int st = i % L::STAGES, t0 = (first + i) * L::NS;
    const E* ks = kv_s + 2 * st * L::TILE;
    const uint8_t* mk = mask_s + st * L::NS;

    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    mma_abt<E, D, L::DP, NT>(
        sc,
        [&](int kk, uint32_t(&a)[4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
        },
        ks, lane);

    const int t0q = t0 - s.q_offset;  // the tile's first key, query frame
    bool plain = all_keys;  // warp-uniform
    if (s.causal) {
      plain = plain && t0q + L::NS - 1 <= qw0;
      if (s.window > 0) plain = plain && qw0 + 15 - t0q < s.window;
    }
    if (plain) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= s.scale;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), kj = t0q + c;
          const int qi = e < 2 ? r0 : r1;
          const int code = mk[c];
          sc[j][e] = code == 0 ? -INFINITY
                     : code == 2 && in_band(s, qi, kj) ? sc[j][e] * s.scale
                                                       : kNegInf;
        }
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float c0 = exp2_approx((m0 - mx0) * kLog2e);
    const float c1 = exp2_approx((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    if (plain) {  // real scores and maxima: one FMA an element
      const float n0 = -mx0 * kLog2e, n1 = -mx1 * kLog2e;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = exp2_approx(fmaf(sc[j][0], kLog2e, n0));
        sc[j][1] = exp2_approx(fmaf(sc[j][1], kLog2e, n0));
        sc[j][2] = exp2_approx(fmaf(sc[j][2], kLog2e, n1));
        sc[j][3] = exp2_approx(fmaf(sc[j][3], kLog2e, n1));
      }
    } else {  // x - max first: exact 0 for a masked key of a masked row
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        sc[j][0] = exp2_approx((sc[j][0] - mx0) * kLog2e);
        sc[j][1] = exp2_approx((sc[j][1] - mx0) * kLog2e);
        sc[j][2] = exp2_approx((sc[j][2] - mx1) * kLog2e);
        sc[j][3] = exp2_approx((sc[j][3] - mx1) * kLog2e);
      }
    }
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= c0;
      o[j][1] *= c0;
      o[j][2] *= c1;
      o[j][3] *= c1;
    }
    mma_px<E, D, L::DP, NT>(o, sc, ks + L::TILE, lane);
    __syncthreads();  // stage st is refilled next iteration
    all_keys = all_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  // a row whose visited keys were all masked averages them: finite, and the
  // clamped LSE makes its backward exactly zero
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const size_t ld = static_cast<size_t>(s.H) * D;
  E* o0 = out + ((static_cast<size_t>(b) * s.Tq + r0) * s.H + h) * D + 2 * t;
  if (r0 < s.Tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(o0 + 8 * j, o[j][0] / d0, o[j][1] / d0);
    if (t == 0)
      lse[static_cast<size_t>(bh) * s.Tq + r0] = fmaxf(m0, -1e20f) + logf(d0);
  }
  if (r1 < s.Tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(o0 + 8 * ld + 8 * j, o[j][2] / d1, o[j][3] / d1);
    if (t == 0)
      lse[static_cast<size_t>(bh) * s.Tq + r1] = fmaxf(m1, -1e20f) + logf(d1);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <typename E, int D>
constexpr size_t dq_smem() {
  using L = DqTc<E, D>;
  return (2 * L::ROWS * L::DP + L::STAGES * 2 * L::TILE) * sizeof(E) +
         L::STAGES * L::NS;
}

template <typename E, int D>
__global__ void __launch_bounds__(DqTc<E, D>::THREADS)
flash_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, const uint8_t* __restrict__ valid,
                const E* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, E* __restrict__ dq, Shape s) {
  using L = DqTc<E, D>;
  constexpr int NT = L::NS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_s = reinterpret_cast<E*>(smem);      // this block's 64 query rows
  E* do_s = q_s + L::ROWS * L::DP;          // and their rows of dO
  E* kv_s = do_s + L::ROWS * L::DP;         // stage st: K at 2*st, V at 2*st+1
  uint8_t* mask_s =
      reinterpret_cast<uint8_t*>(kv_s + L::STAGES * 2 * L::TILE);

  const int bh = blockIdx.x, b = bh / s.H, h = bh - b * s.H;
  const int hk = h / (s.H / s.Hkv);
  // causal: the last query tiles see the most keys; launch them first
  const int qt = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * L::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int qw0 = q0 + warp * 16;                   // this warp's first row
  if (valid != nullptr) valid += static_cast<size_t>(b) * s.Tk;
  // this thread's rows: -LSE.log2(e) and delta (zero past Tq, never stored)
  const size_t srow = static_cast<size_t>(bh) * s.Tq;
  const float nl0 = r0 < s.Tq ? -lse[srow + r0] * kLog2e : 0.f;
  const float nl1 = r1 < s.Tq ? -lse[srow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < s.Tq ? delta[srow + r0] : 0.f;
  const float dl1 = r1 < s.Tq ? delta[srow + r1] : 0.f;

  int lo = 0, hi = s.Tk;
  if (s.causal) {  // stop at the diagonal
    hi = min(hi, max(0, min(q0 + L::ROWS, s.Tq) + s.q_offset));
    if (s.window > 0)
      lo = max(0, q0 + s.q_offset - (s.window - 1));
  }
  const int first = lo / L::NS;
  const int n = max(0, (hi + L::NS - 1) / L::NS - first);

  auto issue = [&](int i) {
    const int st = i % L::STAGES, t0 = (first + i) * L::NS;
    E* ks = kv_s + 2 * st * L::TILE;
    copy_rows<E, D, L::DP, L::NS>(ks, k, b, hk, s.Hkv, s.Tk, t0);
    copy_rows<E, D, L::DP, L::NS>(ks + L::TILE, v, b, hk, s.Hkv, s.Tk, t0);
    // 0: past the end (-inf), 1: masked by key_valid (-1e30), 2: a key
    bool all_keys = true;
    for (int j = threadIdx.x; j < L::NS; j += blockDim.x) {
      const int kj = t0 + j;
      const uint8_t code =
          kj >= s.Tk ? 0 : (valid == nullptr || valid[kj]) ? 2 : 1;
      mask_s[st * L::NS + j] = code;
      all_keys = all_keys && code == 2;
    }
    return all_keys;
  };

  // this warp's 16 rows of Q and dO, A operands read at each tile
  copy_rows<E, D, L::DP, L::ROWS>(q_s, q, b, h, s.H, s.Tq, q0);
  copy_rows<E, D, L::DP, L::ROWS>(do_s, dout, b, h, s.H, s.Tq, q0);
  const E* qw = q_s + warp * 16 * L::DP;
  const E* dow = do_s + warp * 16 * L::DP;

  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  const float sl = s.scale * kLog2e;

  // all_keys: the tile holds no masked or missing key
  bool all_keys = n > 0 ? issue(0) : true;
  cp_async_commit();
  all_keys = __syncthreads_and(all_keys);
  for (int i = 0; i < n; ++i) {
    const bool next = i + 1 < n ? issue(i + 1) : true;
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and the query rows) have landed
    const bool all_next = __syncthreads_and(next);
    const int st = i % L::STAGES, t0 = (first + i) * L::NS;
    const E* ks = kv_s + 2 * st * L::TILE;
    const uint8_t* mk = mask_s + st * L::NS;

    float sp[NT][4], dp[NT][4];  // S, then P; dP, then dS
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
    }
    mma_abt<E, D, L::DP, NT>(
        sp,
        [&](int kk, uint32_t(&a)[4]) { frag_a<E>(a, qw, L::DP, kk, g, t); },
        ks, lane);
    mma_abt<E, D, L::DP, NT>(
        dp,
        [&](int kk, uint32_t(&a)[4]) { frag_a<E>(a, dow, L::DP, kk, g, t); },
        ks + L::TILE, lane);

    const int t0q = t0 - s.q_offset;  // the tile's first key, query frame
    bool plain = all_keys;  // warp-uniform
    if (s.causal) {
      plain = plain && t0q + L::NS - 1 <= qw0;
      if (s.window > 0) plain = plain && qw0 + 15 - t0q < s.window;
    }
    if (plain) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(sp[j][e], sl, e < 2 ? nl0 : nl1));
          dp[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * s.scale;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const int code = mk[c];
          const float x = code == 0 ? -INFINITY
                          : code == 2 && in_band(s, e < 2 ? r0 : r1, t0q + c)
                              ? sp[j][e] * s.scale
                              : kNegInf;
          const float p = exp2_approx(fmaf(x, kLog2e, e < 2 ? nl0 : nl1));
          dp[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1)) * s.scale;
        }
      }
    }
    mma_px<E, D, L::DP, NT>(dqa, dp, ks, lane);  // dQ += dS . K
    __syncthreads();  // stage st is refilled next iteration
    all_keys = all_next;
  }
  cp_async_wait<0>();

  const size_t ld = static_cast<size_t>(s.H) * D;
  E* o0 = dq + ((static_cast<size_t>(b) * s.Tq + r0) * s.H + h) * D + 2 * t;
  if (r0 < s.Tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store2(o0 + 8 * j, dqa[j][0], dqa[j][1]);
  }
  if (r1 < s.Tq) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(o0 + 8 * ld + 8 * j, dqa[j][2], dqa[j][3]);
  }
}

// ---------------------------------------------------------------------------
// backward: dK and dV, summed over the GQA group in f32
// ---------------------------------------------------------------------------

template <typename E, int D>
constexpr size_t dkv_smem() {
  using L = DkvTc<E, D>;
  return (2 * L::ROWS * L::DP + L::STAGES * 2 * L::TILE) * sizeof(E) +
         L::STAGES * 2 * L::NS * sizeof(float);
}

template <typename E, int D>
__global__ void __launch_bounds__(DkvTc<E, D>::THREADS)
flash_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                 const E* __restrict__ v, const uint8_t* __restrict__ valid,
                 const E* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ dk,
                 E* __restrict__ dv, Shape s) {
  using L = DkvTc<E, D>;
  constexpr int NT = L::NS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_s = reinterpret_cast<E*>(smem);  // this block's 64 key rows
  E* v_s = k_s + L::ROWS * L::DP;
  E* ring = v_s + L::ROWS * L::DP;      // stage st: Q at 2*st, dO at 2*st+1
  float* stat_s = reinterpret_cast<float*>(ring + L::STAGES * 2 * L::TILE);
                                        // stage st: LSE, then delta

  const int bk = blockIdx.x, b = bk / s.Hkv, hk = bk - b * s.Hkv;
  const int group = s.H / s.Hkv;
  const int k0 = blockIdx.y * L::ROWS;  // causal: early key tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kj0 = k0 + warp * 16 + g, kj1 = kj0 + 8;  // this thread's keys
  const uint8_t* vrow =
      valid == nullptr ? nullptr : valid + static_cast<size_t>(b) * s.Tk;
  const bool ok0 = kj0 < s.Tk && (vrow == nullptr || vrow[kj0]);
  const bool ok1 = kj1 < s.Tk && (vrow == nullptr || vrow[kj1]);
  const int kw0 = k0 + warp * 16;  // this warp's first key
  const bool warp_keys = __all_sync(0xffffffffu, ok0 && ok1);
  // the keys in the queries' frame (q_offset moved across)
  const int kq0 = kj0 - s.q_offset, kq1 = kj1 - s.q_offset;
  const int kwq = kw0 - s.q_offset;

  int lo = 0, hi = s.Tq;
  if (s.causal) {
    // queries above the diagonal never see these keys
    lo = max(0, k0 - s.q_offset);
    if (s.window > 0)
      hi = min(hi, max(0, min(k0 + L::ROWS, s.Tk) - 1 + s.window -
                              s.q_offset));
  }
  const int first = lo / L::NS;
  const int per_head = max(0, (hi + L::NS - 1) / L::NS - first);
  const int n = group * per_head;

  auto issue = [&](int i) {
    const int st = i % L::STAGES, h = hk * group + i / per_head;
    const int i0 = (first + i % per_head) * L::NS;
    E* qs = ring + 2 * st * L::TILE;
    copy_rows<E, D, L::DP, L::NS>(qs, q, b, h, s.H, s.Tq, i0);
    copy_rows<E, D, L::DP, L::NS>(qs + L::TILE, dout, b, h, s.H, s.Tq, i0);
    const size_t row = (static_cast<size_t>(b) * s.H + h) * s.Tq;
    for (int j = threadIdx.x; j < 2 * L::NS; j += blockDim.x) {
      const int c = j % L::NS, qi = i0 + c;
      const float* src = j < L::NS ? lse : delta;
      const bool ok = qi < s.Tq;
      cp_async4(stat_s + st * 2 * L::NS + j, ok ? src + row + qi : src, ok);
    }
  };

  copy_rows<E, D, L::DP, L::ROWS>(k_s, k, b, hk, s.Hkv, s.Tk, k0);
  copy_rows<E, D, L::DP, L::ROWS>(v_s, v, b, hk, s.Hkv, s.Tk, k0);
  if (n > 0) issue(0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }
  const E* kw = k_s + warp * 16 * L::DP;
  const E* vw = v_s + warp * 16 * L::DP;

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i (and the key rows) have landed
    __syncthreads();
    const int st = i % L::STAGES;
    const int i0 = (first + i % per_head) * L::NS;
    const E* qs = ring + 2 * st * L::TILE;
    const E* dos = qs + L::TILE;
    const float* ls = stat_s + st * 2 * L::NS;
    const float* dl = ls + L::NS;

    float sp[NT][4], dp[NT][4];  // S^T, then P^T; dP^T, then dS^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
    }
    mma_abt<E, D, L::DP, NT>(
        sp,
        [&](int kk, uint32_t(&a)[4]) { frag_a<E>(a, kw, L::DP, kk, g, t); },
        qs, lane);
    mma_abt<E, D, L::DP, NT>(
        dp,
        [&](int kk, uint32_t(&a)[4]) { frag_a<E>(a, vw, L::DP, kk, g, t); },
        dos, lane);
    // plain: every (key, query) pair of this warp's tile is visible
    bool plain = warp_keys && i0 + L::NS <= s.Tq;  // warp-uniform
    if (s.causal) {
      plain = plain && i0 >= kwq + 15;
      if (s.window > 0) plain = plain && i0 + L::NS - 1 - kwq < s.window;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), qi = i0 + c;
        const int kj = e < 2 ? kq0 : kq1;
        float p = 0.f, ds = 0.f;
        if (plain || qi < s.Tq) {
          const float x =
              plain || ((e < 2 ? ok0 : ok1) && in_band(s, qi, kj))
                  ? sp[j][e] * s.scale
                  : kNegInf;
          p = exp2_approx((x - ls[c]) * kLog2e);
          ds = p * (dp[j][e] - dl[c]) * s.scale;
        }
        sp[j][e] = p;
        dp[j][e] = ds;
      }
    }
    mma_px<E, D, L::DP, NT>(dva, sp, dos, lane);  // dV += P^T . dO
    mma_px<E, D, L::DP, NT>(dka, dp, qs, lane);   // dK += dS^T . Q
    __syncthreads();  // stage st is refilled next iteration
  }
  cp_async_wait<0>();

  const size_t ld = static_cast<size_t>(s.Hkv) * D;
  const size_t off =
      ((static_cast<size_t>(b) * s.Tk + kj0) * s.Hkv + hk) * D + 2 * t;
  if (kj0 < s.Tk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + off + 8 * j, dka[j][0], dka[j][1]);
      store2(dv + off + 8 * j, dva[j][0], dva[j][1]);
    }
  }
  if (kj1 < s.Tk) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dk + off + 8 * ld + 8 * j, dka[j][2], dka[j][3]);
      store2(dv + off + 8 * ld + 8 * j, dva[j][2], dva[j][3]);
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

// dynamic shared memory above 48 KB has to be allowed once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* valid, void* out, void* lse,
                                int B, int H, int Hkv, int Tq, int Tk, int D,
                                float scale, int causal, int window,
                                int q_offset, int dtype, void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window, q_offset};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    using L = FwdTc<E, DD>;
    constexpr size_t bytes = fwd_smem<E, DD>();
    static const cudaError_t allowed = allow_smem(flash_fwd_kernel<E, DD>, bytes);
    if (allowed != cudaSuccess) return allowed;
    const dim3 grid(B * H, (Tq + L::ROWS - 1) / L::ROWS);
    flash_fwd_kernel<E, DD><<<grid, L::THREADS, bytes, st>>>(
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
                               float scale, int causal, int window,
                               int q_offset, int dtype, void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window, q_offset};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    using L = DqTc<E, DD>;
    constexpr size_t bytes = dq_smem<E, DD>();
    static const cudaError_t allowed = allow_smem(flash_dq_kernel<E, DD>, bytes);
    if (allowed != cudaSuccess) return allowed;
    const dim3 grid(B * H, (Tq + L::ROWS - 1) / L::ROWS);
    flash_dq_kernel<E, DD><<<grid, L::THREADS, bytes, st>>>(
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
                                int window, int q_offset, int dtype,
                                void* stream) {
  const Shape s{B, H, Hkv, Tq, Tk, scale, causal, window, q_offset};
  if (bad_shape(s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, [&](auto e, auto d) {
    using E = decltype(e);
    constexpr int DD = decltype(d)::value;
    using L = DkvTc<E, DD>;
    constexpr size_t bytes = dkv_smem<E, DD>();
    static const cudaError_t allowed = allow_smem(flash_dkv_kernel<E, DD>, bytes);
    if (allowed != cudaSuccess) return allowed;
    const dim3 grid(B * Hkv, (Tk + L::ROWS - 1) / L::ROWS);
    flash_dkv_kernel<E, DD><<<grid, L::THREADS, bytes, st>>>(
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
