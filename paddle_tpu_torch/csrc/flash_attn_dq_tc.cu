// Flash-attention backward dQ on the H100's tensor cores, bf16: kernel B3 of
// the port for bf16 inputs (f32 inputs take the SIMT kernel in
// flash_attn_bwd.cu).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_attn_bwd_dq_kernel
// (launched by _flash_bwd_bh through pl.pallas_call). Same function,
// FlashAttention-2 recompute: for one query tile, over the key tiles it sees
// (up to the diagonal's tile when causal, the reference's last_kb),
//     S  = scale * (q . K^T),  causal: S = -1e30 where q_pos < k_pos
//     P  = exp(S - LSE)                       (LSE saved by the forward)
//     dP = dO . V^T
//     dS = P * (dP - Dl),  Dl = rowsum(dO * O) (given, f32)
//     dQ += dS . K,  and dQ *= scale once at the end, as the reference does
// The reference's two-kernel split is kept: B2 writes dK and dV, this kernel
// writes dQ, no block writes what another writes, and there are no atomics.
//
// What bounds it on the H100: 6*B*H*S^2*D flops (half that when causal)
// against reads of q, k, v, dO (4*B*S*H*D bf16), LSE and Dl and the write of
// dQ. At the GPT-medium training shape (B=4, S=1024, H=16, D=64, causal)
// that is 12.9 GFLOP (13.0 us at 989 TFLOP/s) against 42.5 MB (12.7 us at
// 3.35 TB/s): bound by operations, just.
//
// Design: FlashAttention-2's dQ pass on mma.sync m16n8k16, laid out as the
// forward (flash_attn_fwd_tc.cu). A block owns 64 query rows of one (batch,
// head) and runs 4 warps, 16 rows each; grid (S/64, B*H). When causal,
// blockIdx.x 0 takes the last query tile, whose key loop is the longest, so
// the longest blocks start first. Q and dO are copied once into bf16 shared
// tiles with cp.async; each lane keeps the LSE and Dl of its two rows (g and
// g + 8) in registers. K and V tiles of 64 keys stream through a two-stage
// cp.async ring: the next tile's copy is in flight while the current one is
// multiplied. Shared tiles are bf16 with 16-byte chunks XOR-swizzled by row,
// so ldmatrix reads them without bank conflicts. Per key tile and warp:
//     S  = Q . K^T     A = Q (registers), B = K rows (ldmatrix)
//     dP = dO . V^T    A = dO (registers), B = V rows (ldmatrix)
//     dS = P * (dP - Dl)   in f32 registers; the mask only on the tile that
//                          crosses the diagonal
//     dQ += dS . K     A = dS (bf16, registers), B = K (ldmatrix.trans)
// The accumulator layout of two n8 tiles is the A layout of one k16 slice, so
// dS never touches shared memory, and no barrier but the ring's is needed.
// Registers are the limit: dQ takes D/2 f32 per thread for the whole loop,
// S and dP 2 * BK/2 per tile. At D = 64 Q's and dO's A fragments (16
// registers each) stay in registers for the whole loop; at D = 128 they
// would take 64 of them, so each is reloaded from shared memory per tile,
// one k16 slice just before its products. Either way ptxas fills most of
// the 255-register budget without spilling; its register and spill lines
// for both are printed by chip_smoke.py's build phase. Shared memory: 48 KB at D = 64 (Q, dO 16 KB; 2 x (K, V) 32 KB),
// 96 KB at D = 128.
//
// Where the numerics differ from the reference: dS is rounded to bf16 as an
// mma operand (relative 2^-9 per term), and the scale is applied to the f32
// S instead of to q (the reference scales q in f32; the two agree up to f32
// rounding). dQ's relative L2 gap to the f32 plain version stays within 2^-7
// (chip_smoke.py, tests/test_torch_cuda.py).
//
// f32 inputs keep the SIMT kernel: TF32 tensor cores would keep only about
// three decimal digits and break the f32 correctness gates that rest on B3
// (grads within 1e-3 relative L2 in chip_smoke.py's train_check, 1e-4
// elementwise against the plain version). f32 is the port's correctness
// dtype, bf16 its hot path.
//
// Inputs are (B, S, H, D) bf16 with any batch, sequence and head strides
// that are multiples of 8 elements, a unit stride on D and 16-byte-aligned
// base pointers (cp.async copies 16 bytes); the wrapper copies an operand
// that breaks this. dQ is written contiguous (B, S, H, D) bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

using ptk::bf16;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per streamed tile
constexpr int WARPS = 4;      // 16 query rows each
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_BIG = -1e30f;

static_assert(BQ == 16 * WARPS, "one m16 row block per warp");

template <int D>
struct Cfg {
  static constexpr bool QO_IN_REGS = D == 64;   // Q, dO fragments kept
  static constexpr int QT = BQ * D;             // elements of Q or dO
  static constexpr int KV = BK * D;             // elements of one K or V tile
  // Q, dO; two stages of (K, V)
  static constexpr size_t BYTES = sizeof(bf16) * (size_t)(2 * QT + 4 * KV);
};

// element strides (batch, seq, head) of q, k, v and dO
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dq, int S, int H, float scale,
                       int causal, Strides st) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + C::QT;
  bf16* ring = dOs + C::QT;   // stage s: K at ring + 2*s*KV, V after it

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

  const bf16* kb = k + b * st.k[0] + h * st.k[2];
  const bf16* vb = v + b * st.v[0] + h * st.v[2];
  // key tiles up to the diagonal when causal (the reference's last_kb)
  const int n_kt = causal ? min((q0 + BQ + BK - 1) / BK, S / BK) : S / BK;

  ptk::load_tile_async<BQ, D, THREADS>(
      Qs, q + b * st.q[0] + h * st.q[2] + q0 * st.q[1], st.q[1]);
  ptk::load_tile_async<BQ, D, THREADS>(
      dOs, dout + b * st.o[0] + h * st.o[2] + q0 * st.o[1], st.o[1]);
  ptk::load_tile_async<BK, D, THREADS>(ring, kb, st.k[1]);
  ptk::load_tile_async<BK, D, THREADS>(ring + C::KV, vb, st.v[1]);
  ptk::cp_async_commit();

  // LSE and Dl of rows g and g + 8
  float l_row[2], d_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = (long long)bh * S + q0 + row_w + g + r * 8;
    l_row[r] = lse[i];
    d_row[r] = delta[i];
  }

  uint32_t qf[D / 16][4];
  uint32_t of[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * BK;
    const bf16* Ks = ring + (t & 1) * 2 * C::KV;
    const bf16* Vs = Ks + C::KV;
    if (t + 1 < n_kt) {
      bf16* next = ring + ((t + 1) & 1) * 2 * C::KV;
      ptk::load_tile_async<BK, D, THREADS>(next, kb + (k0 + BK) * st.k[1],
                                           st.k[1]);
      ptk::load_tile_async<BK, D, THREADS>(next + C::KV,
                                           vb + (k0 + BK) * st.v[1], st.v[1]);
      ptk::cp_async_commit();
      ptk::cp_async_wait<1>();
    } else {
      ptk::cp_async_wait<0>();
    }
    __syncthreads();   // this stage's copies (and Q's, dO's) are visible
    if (C::QO_IN_REGS && t == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        ptk::ldsm_a<D>(qf[kc], Qs, row_w, kc, lane);
        ptk::ldsm_a<D>(of[kc], dOs, row_w, kc, lane);
      }
    }

    // S = Q . K^T and dP = dO . V^T for the warp's 16 rows and 64 keys
    float s[BK / 8][4];
    float dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.f;
        dp[j][e] = 0.f;
      }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      if (!C::QO_IN_REGS) {
        ptk::ldsm_a<D>(qf[kc], Qs, row_w, kc, lane);
        ptk::ldsm_a<D>(of[kc], dOs, row_w, kc, lane);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ptk::ldsm_b<D>(bf, Ks, np * 16, kc, lane);
        ptk::mma(s[2 * np], qf[kc], bf[0], bf[1]);
        ptk::mma(s[2 * np + 1], qf[kc], bf[2], bf[3]);
        ptk::ldsm_b<D>(bf, Vs, np * 16, kc, lane);
        ptk::mma(dp[2 * np], of[kc], bf[0], bf[1]);
        ptk::mma(dp[2 * np + 1], of[kc], bf[2], bf[3]);
      }
    }

    // dS = exp(scale * S - LSE) * (dP - Dl) in f32, masked where q_pos <
    // k_pos on the tile that crosses the diagonal; kept in s
    const bool masked = causal && k0 + BK - 1 > q0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * scale;
        if (masked && q0 + row_w + g + r * 8 < k0 + j * 8 + 2 * tq + (e & 1))
          x = NEG_BIG;
        s[j][e] = __expf(x - l_row[r]) * (dp[j][e] - d_row[r]);
      }
    }

    // dQ += dS . K, dS rounded to bf16 in registers
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t da[4];
      ptk::acc_to_a(da, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bf[4];
        ptk::ldsm_b_trans<D>(bf, Ks, kc, dn * 16, lane);
        ptk::mma(acc[2 * dn], da, bf[0], bf[1]);
        ptk::mma(acc[2 * dn + 1], da, bf[2], bf[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its refill
  }

  // dS was formed from S = scale * q . K^T; the reference's dQ carries the
  // scale once, at the end
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_w + g + r * 8;
    bf16* dq_row = dq + ((long long)(b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq_row + j * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale,
                                acc[j][2 * r + 1] * scale);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int S, int H, float scale, int causal,
                   const Strides& st, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  const size_t smem = Cfg<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, H, scale, causal, st);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout: (B, S, H, D) bf16 with element strides (batch, seq, head)
// given for each, in that order, multiples of 8, unit stride on D and
// 16-byte-aligned bases; lse and delta contiguous (B, H, S) f32; dq
// contiguous (B, S, H, D) bf16. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
extern "C" int pt_flash_attn_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int D,
    int causal, float scale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % BQ != 0 || S % BK != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  for (long long x : s)
    if (x % 8 != 0) return (int)cudaErrorMisalignedAddress;
  const void* ptrs[7] = {q, k, v, dout, lse, delta, dq};
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
    return (int)launch<64>(q, k, v, dout, lse, delta, dq, B, S, H, scale,
                           causal, st, cs);
  if (D == 128)
    return (int)launch<128>(q, k, v, dout, lse, delta, dq, B, S, H, scale,
                            causal, st, cs);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
