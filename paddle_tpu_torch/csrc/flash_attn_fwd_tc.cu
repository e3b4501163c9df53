// Flash-attention forward on the H100's tensor cores, bf16: kernel B1 of the
// port for bf16 inputs (f32 inputs take the SIMT kernel in flash_attn_fwd.cu).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_attn_fwd_kernel
// (launched by _flash_fwd_bh through pl.pallas_call). Same function: for each
// query row an online softmax over key tiles,
//     S = scale * (q . K^T)            (f32 accumulators of bf16 products)
//     causal: S = -1e30 where q_pos < k_pos, and the key loop stops at the
//             diagonal tile
//     m, l, O rescaled by exp(m_prev - m_new) per tile
//     O = acc / max(l, 1e-30)          (stored as bf16, and on request
//                                       also as f32)
//     LSE = m + log(max(l, 1e-30))     (stored as (B, H, S) f32)
// with the reference's constants (m0 = -1e30, masked score -1e30, l floor
// 1e-30).
//
// What bounds it on the H100: one pass reads q, k, v and writes O and LSE,
// 4*B*S*H*D bf16 elements plus B*H*S floats, while the products take
// 4*B*H*S^2*D flops (half that when causal). At the GPT-medium prefill (B=4,
// H=16, S=512, D=64, causal) that is 16.9 MB (5.05 us at 3.35 TB/s) against
// 2.1 GFLOP (2.2 us at 989 TFLOP/s); at the training shape (S=1024) 33.8 MB
// (10.09 us) against 8.6 GFLOP (8.7 us): bound by bytes at both. The
// training path's launch also writes O in f32, 4 more bytes per element.
//
// Design (FlashAttention-2 on mma.sync). A block owns BQ query rows of one
// (batch, head) and runs BQ/16 warps, 16 rows each; grid (S/BQ, B*H). BQ is
// a template parameter, instantiated at 64 (4 warps) and 128 (8 warps); the
// caller picks one per shape (ops/cuda/flash_attention.py
// _tuned_fwd_blocks, timed by ops/autotune.py on the card). A warp's work
// and registers are the same in both: the larger block shares each K and V
// tile between twice the query rows (half the K/V reads from L2) and puts
// half as many blocks on the grid. When
// causal, blockIdx.x 0 takes the last query tile, so the longest blocks start
// first. Q's tile is copied once into bf16 shared memory with cp.async and
// its A fragments stay in registers for the whole key loop. K and V tiles of
// 64 keys stream through a two-stage cp.async ring: the next tile's copy is
// in flight while the current one is multiplied. Shared tiles are bf16 with
// 16-byte chunks XOR-swizzled by row, so ldmatrix reads them without bank
// conflicts: 40 KB at D = 64 (Q 8 KB + 2 x (K + V) 32 KB), 80 KB at D = 128
// for BQ = 64; the Q tile doubles at BQ = 128 (48 KB and 96 KB).
// S = Q . K^T is one m16n8k16 mma per (n8 key tile, k16 slice), K's B
// fragments by ldmatrix; the scale multiplies the f32 accumulator, never q in
// bf16 (the reference scales q in f32; scaling S in f32 agrees with it up to
// f32 rounding, exactly for D = 64). The mask is applied only on the tile
// that crosses the diagonal. The row max and row sum are reduced over the
// four lanes that hold a row (__shfl_xor_sync 1, 2); the sum is kept per
// lane and reduced once at the end. P is rounded to bf16 in registers and is
// the A operand of P . V directly (the accumulator layout of two n8 tiles is
// the A layout of one k16 slice); V's B fragments come from ldmatrix.trans.
//
// Where the numerics differ from the reference: P is rounded to bf16 as an
// mma operand (relative 2^-9 per term) while l sums the f32 P, and the scale
// is applied to the f32 S instead of to q. O's relative L2 gap to the f32
// plain version stays within 2^-7 (chip_smoke.py, tests/test_torch_cuda.py).
// When a backward follows, the wrapper passes o32 and the kernel also stores
// O unrounded: the backward's D = rowsum(dO . O) then reads the f32 O, where
// the reference reads its bf16 O, whose rounding would enter every dS of a
// row with one sign (the sum of a row of dS, zero in exact arithmetic, is
// what the key projection's bias and the mean key carry into dK and dQ).
//
// f32 inputs keep the SIMT kernel: TF32 tensor cores would keep only about
// three decimal digits and break the f32 correctness gates that rest on B1
// (kernel vs plain O within 2e-5, greedy tokens identical at full width,
// grads within 1e-3 relative L2). f32 is the port's correctness dtype, bf16
// its hot path.
//
// Inputs are (B, S, H, D) bf16 with any batch, sequence and head strides
// that are multiples of 8 elements, a unit stride on D and 16-byte-aligned
// base pointers (cp.async copies 16 bytes); the wrapper copies an operand
// that breaks this. The strided q/k/v views that GPTAttention slices out of
// its fused qkv projection satisfy it and are read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using ptk::bf16;

constexpr int BK = 64;        // keys per streamed tile
constexpr float NEG_BIG = -1e30f;
constexpr float L_FLOOR = 1e-30f;

template <int D, int BQ>
struct Smem {
  static constexpr int Q = BQ * D;     // elements of the Q tile
  static constexpr int KV = BK * D;    // elements of one K or V tile
  // Q, then two stages of (K, V)
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(Q + 4 * KV);
};

template <int D, int BQ>
__global__ void __launch_bounds__(32 * (BQ / 16))
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ o32, float* __restrict__ lse, int S,
                    int H, float scale,
                    int causal, long long q_sb, long long q_ss, long long q_sh,
                    long long k_sb, long long k_ss, long long k_sh,
                    long long v_sb, long long v_ss, long long v_sh) {
  constexpr int KV = Smem<D, BQ>::KV;
  constexpr int THREADS = 32 * (BQ / 16);   // 16 query rows a warp
  static_assert(BQ % 16 == 0, "one m16 row block per warp");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = Qs + Smem<D, BQ>::Q;   // stage s: K at ring + 2*s*KV, V after

  const int lane = threadIdx.x & 31;
  const int row_w = (threadIdx.x >> 5) * 16;   // the warp's first tile row
  const int g = lane >> 2;                     // fragment row (and row + 8)
  const int tq = lane & 3;                     // fragment column pair
  const int n_qt = S / BQ;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  // key tiles up to the diagonal when causal (the reference's last_kb)
  const int n_kt = causal ? min((q0 + BQ + BK - 1) / BK, S / BK) : S / BK;

  ptk::load_tile_async<BQ, D, THREADS>(Qs, q + b * q_sb + h * q_sh + q0 * q_ss,
                                       q_ss);
  ptk::load_tile_async<BK, D, THREADS>(ring, kb, k_ss);
  ptk::load_tile_async<BK, D, THREADS>(ring + KV, vb, v_ss);
  ptk::cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // running max and per-lane partial sum of rows g and g + 8
  float m_run[2] = {NEG_BIG, NEG_BIG};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    const bf16* Ks = ring + (t & 1) * 2 * KV;
    const bf16* Vs = Ks + KV;
    if (t + 1 < n_kt) {
      bf16* next = ring + ((t + 1) & 1) * 2 * KV;
      ptk::load_tile_async<BK, D, THREADS>(next, kb + (k0 + BK) * k_ss, k_ss);
      ptk::load_tile_async<BK, D, THREADS>(next + KV, vb + (k0 + BK) * v_ss,
                                           v_ss);
      ptk::cp_async_commit();
      ptk::cp_async_wait<1>();
    } else {
      ptk::cp_async_wait<0>();
    }
    __syncthreads();   // this stage's copies (and Q's) are visible
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ptk::ldsm_a<D>(qf[kc], Qs, row_w, kc, lane);
    }

    // S = Q . K^T for the warp's 16 rows and the tile's 64 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ptk::ldsm_b<D>(bf, Ks, np * 16, kc, lane);
        ptk::mma(s[2 * np], qf[kc], bf[0], bf[1]);
        ptk::mma(s[2 * np + 1], qf[kc], bf[2], bf[3]);
      }
    }

    // scale in f32, mask the tile that crosses the diagonal, online softmax
    const bool masked = causal && k0 + BK - 1 > q0;
    float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked && q0 + row_w + g + (e >> 1) * 8 < k0 + j * 8 + 2 * tq + (e & 1))
          x = NEG_BIG;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // O += P . V, P rounded to bf16 in registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      ptk::acc_to_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ptk::ldsm_b_trans<D>(bf, Vs, kc, dp * 16, lane);
        ptk::mma(acc[2 * dp], pa, bf[0], bf[1]);
        ptk::mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = fmaxf(l, L_FLOOR);
    const int row = q0 + row_w + g + r * 8;
    const long long o_off = ((long long)(b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[j][2 * r] / l_safe;
      const float x1 = acc[j][2 * r + 1] / l_safe;
      *reinterpret_cast<__nv_bfloat162*>(o + o_off + j * 8 + 2 * tq) =
          __floats2bfloat162_rn(x0, x1);
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + o_off + j * 8 + 2 * tq) =
            make_float2(x0, x1);
    }
    if (tq == 0) lse[(long long)bh * S + row] = m_run[r] + logf(l_safe);
  }
}

template <int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* o32, void* lse, int B, int S, int H, float scale,
                   int causal, const long long* st, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<D, BQ>;
  const size_t smem = Smem<D, BQ>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, 32 * (BQ / 16), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(o32), static_cast<float*>(lse), S, H, scale,
      causal, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, H, D) bf16 with element strides (batch, seq, head) given
// for each, multiples of 8, unit stride on D and 16-byte-aligned bases; o:
// contiguous (B, S, H, D) bf16; o32: null, or contiguous (B, S, H, D) f32
// for O unrounded; lse: contiguous (B, H, S) f32; bq: the query rows per
// block, 64 or 128 (the instantiation). Returns the cudaError_t of the
// launch (0 on success). Does not synchronise.
extern "C" int pt_flash_attn_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* o32,
    void* lse, int B, int S, int H, int D, int causal, int bq, float scale,
    long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || (bq != 64 && bq != 128) || S % bq != 0 ||
      S % BK != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  for (long long x : st)
    if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const void* ptrs[6] = {q, k, v, o, lse, o32};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && bq == 64)
    return (int)launch<64, 64>(q, k, v, o, o32, lse, B, S, H, scale, causal,
                               st, s);
  if (D == 64 && bq == 128)
    return (int)launch<64, 128>(q, k, v, o, o32, lse, B, S, H, scale, causal,
                                st, s);
  if (D == 128 && bq == 64)
    return (int)launch<128, 64>(q, k, v, o, o32, lse, B, S, H, scale, causal,
                                st, s);
  if (D == 128 && bq == 128)
    return (int)launch<128, 128>(q, k, v, o, o32, lse, B, S, H, scale, causal,
                                 st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
