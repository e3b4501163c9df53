// Flash-attention backward dK/dV on the H100's tensor cores, bf16: kernel B2
// of the port for bf16 inputs (f32 inputs take the SIMT kernel in
// flash_attn_bwd.cu, which also holds B3, dQ, for both dtypes).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_attn_bwd_dkv_kernel
// (launched by _flash_bwd_bh through pl.pallas_call). Same function,
// FlashAttention-2 recompute: for one key tile, over the query tiles that see
// it (from the diagonal's tile when causal, the reference's start_qb),
//     S  = scale * (q . K^T),  causal: S = -1e30 where q_pos < k_pos
//     P  = exp(S - LSE)                       (LSE saved by the forward)
//     dV += P^T . dO
//     dP = dO . V^T,  dS = P * (dP - Dl),  Dl = rowsum(dO * O) (given, f32)
//     dK += dS^T . q,  and dK *= scale once at the end
// The reference forms dK against q * scale; multiplying the sum by the scale
// once is the same up to f32 rounding. The reference's two-kernel split is
// kept: this kernel writes dK and dV only, B3 writes dQ, no block writes what
// another writes, and there are no atomics.
//
// What bounds it on the H100: 8*B*H*S^2*D flops (half that when causal)
// against reads of q, k, v, dO (4*B*S*H*D bf16), LSE and Dl and writes of dK
// and dV. At the GPT-medium training shape (B=4, S=1024, H=16, D=64, causal)
// that is 17.2 GFLOP (17.4 us at 989 TFLOP/s) against 50.9 MB (15.2 us at
// 3.35 TB/s): bound by operations, just.
//
// Design: the transposed formulation, so that neither P nor dS ever goes
// through shared memory. A block owns 64 key rows of one (batch, head), 16
// per warp, grid (S/64, B*H); blockIdx.x 0 (the longest loop when causal)
// starts first. Every product has the warp's key rows as its M side:
//     S^T  = K . Q^T     A = K (registers), B = Q rows (ldmatrix)
//     P^T  = exp(S^T - LSE[q])       LSE indexed by column, from shared
//     dV  += P^T . dO    A = P^T (bf16, registers), B = dO (ldmatrix.trans)
//     dP^T = V . dO^T    A = V (registers), B = dO rows (ldmatrix)
//     dS^T = P^T * (dP^T - Dl[q])    in f32
//     dK  += dS^T . Q    A = dS^T (bf16, registers), B = Q (ldmatrix.trans)
// The accumulator layout of two n8 tiles is the A layout of one k16 slice, so
// P^T and dS^T feed the next product from registers. K and V are copied to
// shared memory once; Q, dO, LSE and Dl tiles stream through a two-stage
// cp.async ring, the next tile's copy in flight while the current one is
// multiplied. Shared tiles are bf16 with 16-byte chunks XOR-swizzled by row
// (no ldmatrix bank conflicts).
// Registers are the limit: dK and dV take 2 * D/2 f32 per thread (64 at D =
// 64, 128 at D = 128) for the whole loop, and S^T and dP^T 2 * BQ/2 per
// query tile. At D = 64 the query tile is 64 wide and K's and V's A
// fragments (16 registers each) stay in registers for the whole loop; at
// D = 128 the query tile is 32 wide and K's and V's fragments are reloaded
// from shared memory per tile, each just before its product. ptxas's
// register and spill lines for both are printed by chip_smoke.py's build
// phase. Shared memory: 49 KB at D = 64 (K, V 16 KB; 2 x (Q, dO) 32 KB; 2 x
// (LSE, Dl) 1 KB), 64.5 KB at D = 128.
//
// Where the numerics differ from the reference: P and dS are rounded to bf16
// as mma operands (relative 2^-9 per term), and the scale is applied to the
// f32 S^T instead of to q. dK's and dV's relative L2 gap to the f32 plain
// version stays within 2^-7 (chip_smoke.py, tests/test_torch_cuda.py).
//
// f32 inputs keep the SIMT kernel: TF32 tensor cores would keep only about
// three decimal digits and break the f32 correctness gates that rest on B2
// (grads within 1e-3 relative L2 in chip_smoke.py's train_check, 1e-4
// elementwise against the plain version). f32 is the port's correctness
// dtype, bf16 its hot path.
//
// Inputs are (B, S, H, D) bf16 with any batch, sequence and head strides
// that are multiples of 8 elements, a unit stride on D and 16-byte-aligned
// base pointers (cp.async copies 16 bytes); the wrapper copies an operand
// that breaks this. dK and dV are written contiguous (B, S, H, D) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using ptk::bf16;

constexpr int BK = 64;        // key rows per block
constexpr int WARPS = 4;      // 16 key rows each
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_BIG = -1e30f;

static_assert(BK == 16 * WARPS, "one m16 row block per warp");

template <int D>
struct Cfg {
  static constexpr int BQ = D == 64 ? 64 : 32;   // query rows per tile
  static constexpr bool KV_IN_REGS = D == 64;    // K, V fragments kept
  static constexpr int KV = BK * D;              // elements of K or V
  static constexpr int QT = BQ * D;              // elements of Q or dO
  // K, V; two stages of (Q, dO); two stages of (LSE, Dl)
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(2 * KV + 4 * QT) +
                                  sizeof(float) * (size_t)(4 * BQ);
};

// element strides (batch, seq, head) of q, k, v and dO
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int H, float scale, int causal, Strides st) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::KV;
  bf16* ring = Vs + C::KV;   // stage s: Q at ring + 2*s*QT, dO after it
  float* vecs = reinterpret_cast<float*>(ring + 4 * C::QT);
  // stage s: LSE at vecs + 2*s*BQ, Dl after it

  const int lane = threadIdx.x & 31;
  const int row_w = (threadIdx.x >> 5) * 16;   // the warp's first key row
  const int g = lane >> 2;                     // fragment row (and row + 8)
  const int tq = lane & 3;                     // fragment column pair
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;

  const bf16* qb = q + b * st.q[0] + h * st.q[2];
  const bf16* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lse_bh = lse + (long long)bh * S;
  const float* dl_bh = delta + (long long)bh * S;
  const int n_qt = S / BQ;
  // only query tiles at or below the diagonal see this key tile when causal
  // (the reference's start_qb)
  const int t0 = causal ? k0 / BQ : 0;

  auto load_stage = [&](int t, int stage) {
    const int q0 = t * BQ;
    bf16* qd = ring + 2 * stage * C::QT;
    ptk::load_tile_async<BQ, D, THREADS>(qd, qb + q0 * st.q[1], st.q[1]);
    ptk::load_tile_async<BQ, D, THREADS>(qd + C::QT, ob + q0 * st.o[1],
                                         st.o[1]);
    float* vd = vecs + 2 * stage * BQ;
    ptk::load_vec_async<BQ>(vd, lse_bh + q0);
    ptk::load_vec_async<BQ>(vd + BQ, dl_bh + q0);
  };

  ptk::load_tile_async<BK, D, THREADS>(
      Ks, k + b * st.k[0] + h * st.k[2] + k0 * st.k[1], st.k[1]);
  ptk::load_tile_async<BK, D, THREADS>(
      Vs, v + b * st.v[0] + h * st.v[2] + k0 * st.v[1], st.v[1]);
  load_stage(t0, 0);
  ptk::cp_async_commit();

  uint32_t kf[D / 16][4];
  uint32_t vf[D / 16][4];
  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }

  for (int t = t0; t < n_qt; ++t) {
    const int stage = (t - t0) & 1;
    const int q0 = t * BQ;
    const bf16* Qs = ring + 2 * stage * C::QT;
    const bf16* dOs = Qs + C::QT;
    const float* Ls = vecs + 2 * stage * BQ;
    const float* Dls = Ls + BQ;
    if (t + 1 < n_qt) {
      load_stage(t + 1, stage ^ 1);
      ptk::cp_async_commit();
      ptk::cp_async_wait<1>();
    } else {
      ptk::cp_async_wait<0>();
    }
    __syncthreads();   // this stage's copies (and K's, V's) are visible
    if (C::KV_IN_REGS ? t == t0 : true) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ptk::ldsm_a<D>(kf[kc], Ks, row_w, kc, lane);
    }
    if (C::KV_IN_REGS && t == t0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ptk::ldsm_a<D>(vf[kc], Vs, row_w, kc, lane);
    }

    // S^T = K . Q^T for the warp's 16 keys and the tile's BQ queries
    float sp[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bf[4];
        ptk::ldsm_b<D>(bf, Qs, np * 16, kc, lane);
        ptk::mma(sp[2 * np], kf[kc], bf[0], bf[1]);
        ptk::mma(sp[2 * np + 1], kf[kc], bf[2], bf[3]);
      }
    }

    // P^T = exp(scale * S^T - LSE[q]), masked where q_pos < k_pos on the
    // tiles that cross the diagonal
    const bool masked = causal && q0 < k0 + BK - 1;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      const float l_q[2] = {Ls[c], Ls[c + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sp[j][e] * scale;
        if (masked && q0 + c + (e & 1) < k0 + row_w + g + (e >> 1) * 8)
          x = NEG_BIG;
        sp[j][e] = __expf(x - l_q[e & 1]);
      }
    }

    // dV += P^T . dO
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4];
      ptk::acc_to_a(pa, sp[2 * kc], sp[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ptk::ldsm_b_trans<D>(bf, dOs, kc, dp * 16, lane);
        ptk::mma(dv_acc[2 * dp], pa, bf[0], bf[1]);
        ptk::mma(dv_acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }

    // dP^T = V . dO^T
    if (!C::KV_IN_REGS) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ptk::ldsm_a<D>(vf[kc], Vs, row_w, kc, lane);
    }
    float ds[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bf[4];
        ptk::ldsm_b<D>(bf, dOs, np * 16, kc, lane);
        ptk::mma(ds[2 * np], vf[kc], bf[0], bf[1]);
        ptk::mma(ds[2 * np + 1], vf[kc], bf[2], bf[3]);
      }
    }

    // dS^T = P^T * (dP^T - Dl[q]) in f32
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      const float d_q[2] = {Dls[c], Dls[c + 1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = sp[j][e] * (ds[j][e] - d_q[e & 1]);
    }

    // dK += dS^T . Q
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t pa[4];
      ptk::acc_to_a(pa, ds[2 * kc], ds[2 * kc + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bf[4];
        ptk::ldsm_b_trans<D>(bf, Qs, kc, dp * 16, lane);
        ptk::mma(dk_acc[2 * dp], pa, bf[0], bf[1]);
        ptk::mma(dk_acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

  // dS was formed from S = scale * q . K^T; the reference's dK is against
  // q * scale, so the sum carries the scale once
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row =
        ((long long)(b * S + k0 + row_w + g + r * 8) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + row + col) =
          __floats2bfloat162_rn(dk_acc[j][2 * r] * scale,
                                dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + col) =
          __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int B, int S, int H, float scale,
                   int causal, const Strides& st, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_tc_kernel<D>;
  const size_t smem = Cfg<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BK, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, scale, causal, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (B, S, H, D) bf16 with element strides (batch, seq, head)
// given for each, in that order, multiples of 8, unit stride on D and
// 16-byte-aligned bases; lse and delta contiguous (B, H, S) f32; dk, dv
// contiguous (B, S, H, D) bf16. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
extern "C" int pt_flash_attn_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, int causal, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, void* stream) {
  // BK is a multiple of both query-tile widths
  if (B <= 0 || H <= 0 || S <= 0 || S % BK != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  for (long long x : s)
    if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const void* ptrs[8] = {q, k, v, dout, lse, delta, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale,
                           causal, st, cs);
  if (D == 128)
    return (int)launch<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H, scale,
                            causal, st, cs);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
