// Flash-attention backward for Hopper (sm_90a), f32: kernels B2 (dK, dV) and
// B3 (dQ) of the port for f32 inputs (bf16 inputs take the tensor-core
// kernels in flash_attn_dkv_tc.cu and flash_attn_dq_tc.cu).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_attn_bwd_dkv_kernel
// (B2) and ::_attn_bwd_dq_kernel (B3), both launched by _flash_bwd_bh
// through pl.pallas_call. Same functions, FlashAttention-2 recompute: the
// forward saved only LSE, so each probability tile is formed again,
//     S  = (q * scale) . K^T             (f32; q scaled in f32 first)
//     causal: S = -1e30 where q_pos < k_pos, so P = exp(S - LSE) = 0 there
//     P  = exp(S - LSE)
//     dP = dO . V^T
//     dS = P * (dP - Dl),  Dl = rowsum(dO * O)  (given, f32, (B, H, S))
// B2:  dV = sum over q of P^T . dO,  dK = sum over q of dS^T . (q * scale)
// B3:  dQ = scale * sum over k of dS . K
// with the reference's constants and scale placement, and its two-kernel
// split: B2 owns one key tile and loops over query tiles (from the
// diagonal's tile when causal); B3 owns one query tile and loops over key
// tiles (up to the diagonal's tile when causal). No block writes what
// another block writes, so there are no atomics and the result does not
// depend on the order in which blocks run.
//
// What bounds them on the H100: B2 does 8*B*H*S^2*D flops and B3
// 6*B*H*S^2*D (half that when causal), against reads of q, k, v, dO
// (4*B*S*H*D elements), LSE and Dl, and writes of dK, dV (B2) or dQ (B3).
// In f32 at (B=4, S=512, H=16, D=64, causal) B2 is 4.3 GFLOP (64.1 us at the
// 67 TFLOP/s of f32 outside the tensor cores) against 50.6 MB (15.1 us at
// 3.35 TB/s), and B3 3.2 GFLOP (48.1 us) against 42.2 MB (12.6 us): both
// bound by operations.
//
// Design. Each (tile, b*h) pair is its own block of 256 threads; at the
// training shape that is 16 * 64 = 1024 blocks per kernel, enough for the
// 132 SMs with no cross-block state. Tiles are 64 x 64 (BQ = BK = 64) and
// are kept in f32 in shared memory with padded rows (no bank conflicts),
// and every product is a plain f32 FMA (no TF32). Four threads own one row:
// in the score phase each computes 16 of the 64 entries of S and dP for
// its row, as B1 does.
//   B2 keeps its key tile's K and V in shared memory and its dK and dV
//   accumulators in registers (thread (row, slot) owns D/4 columns of both
//   for one key row: 32 floats at D = 64, 64 at D = 128). Per query tile it
//   stages q * scale and dO, forms P and dS for the whole 64 x 64 tile into
//   shared memory, and after one block barrier each thread reads the
//   column of P and dS of its own key row. Shared memory: 98 KB at D = 64,
//   162 KB at D = 128.
//   B3 stages its query tile (q * scale, dO, LSE and Dl per row) once and
//   streams K and V tiles; each thread writes its row's dS to a padded
//   shared-memory row and, after a warp barrier (the row's four threads
//   share a warp), adds dS . K into D/4 f32 registers. dQ is scaled once at
//   the end. Shared memory: 81 KB at D = 64, 145 KB at D = 128.
// Both working sets are above the 48 KB static limit, so the launchers
// raise the dynamic shared-memory limit first and return any launch error.
//
// These kernels use CUDA-core FMAs fed from shared memory; they are correct
// and simple, not fast (shared-memory loads bound them). They keep this form
// for f32: TF32 tensor cores keep only about three decimal digits and would
// break the f32 correctness gates that rest on them (grads within 1e-3
// relative L2 in chip_smoke.py's train_check, 1e-4 elementwise against the
// plain version); f32 is the port's correctness dtype, and bf16, its hot
// path, takes the tensor-core B2 and B3.
//
// Inputs are (B, S, H, D) with any batch, sequence and head strides and a
// unit stride on D: the strided q/k/v views GPTAttention slices out of its
// fused qkv projection are read in place. dQ, dK and dV are written
// contiguous (B, S, H, D) f32.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;      // threads per tile row (4)
constexpr int COLS = BK / TPR;         // scores per thread per tile (16)
constexpr float NEG_BIG = -1e30f;

static_assert(BQ == BK, "B2's phase 2 maps key rows onto the query-row "
                        "thread layout of phase 1");
static_assert(THREADS == BK * TPR, "four threads per key row in B2");

// element strides (batch, seq, head) of q, k, v and dO
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <int D>
struct Layout {
  static constexpr int STR = D + 1;     // padded D-wide rows
  static constexpr int PSTR = BK + 1;   // padded BK-wide rows
  static constexpr int TILE = 64 * STR;
  static constexpr int PTILE = BQ * PSTR;
  // B2: K, V, Q, dO tiles; P and dS tiles; LSE and Dl of the query tile
  static constexpr size_t DKV_BYTES =
      sizeof(float) * (size_t)(4 * TILE + 2 * PTILE + 2 * BQ);
  // B3: Q, dO, K, V tiles; one dS tile
  static constexpr size_t DQ_BYTES = sizeof(float) * (size_t)(4 * TILE + PTILE);
};

// rows [row0, row0 + 64) of a (S, D) slice with sequence stride `ss` into a
// padded f32 tile, times `mul` (q * scale in f32, as the reference forms it)
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ss, int row0, float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int row = idx / D;
    const int col = idx % D;
    dst[row * Layout<D>::STR + col] =
        src[(long long)(row0 + row) * ss + col] * mul;
  }
}

// Thread (r, j)'s 16 entries of S and dP for query row r of the staged Q
// and dO tiles against keys j + TPR * i of the staged K and V tiles.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int r, int j, float* s, float* dp) {
  constexpr int STR = Layout<D>::STR;
#pragma unroll
  for (int i = 0; i < COLS; ++i) {
    s[i] = 0.f;
    dp[i] = 0.f;
  }
  const float* q_row = Qs + r * STR;
  const float* o_row = dOs + r * STR;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float qd = q_row[d];
    const float od = o_row[d];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int c = (j + TPR * i) * STR + d;
      s[i] = fmaf(qd, Ks[c], s[i]);
      dp[i] = fmaf(od, Vs[c], dp[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int H, float scale,
                     int causal, Strides st) {
  using L = Layout<D>;
  constexpr int STR = L::STR;
  constexpr int PSTR = L::PSTR;
  constexpr int DPT = D / TPR;           // dK/dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::TILE;
  float* Qs = Vs + L::TILE;
  float* dOs = Qs + L::TILE;
  float* Ps = dOs + L::TILE;
  float* dSs = Ps + L::PTILE;
  float* Ls = dSs + L::PTILE;
  float* Dls = Ls + BQ;

  const int tid = threadIdx.x;
  const int r = tid / TPR;   // query row in phase 1, key row in phase 2
  const int j = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* ob = dout + b * st.o[0] + h * st.o[2];
  const float* lse_bh = lse + (long long)bh * S;
  const float* dl_bh = delta + (long long)bh * S;

  stage<D>(Ks, kb, st.k[1], k0, 1.f);
  stage<D>(Vs, vb, st.v[1], k0, 1.f);

  float dk_acc[DPT];
  float dv_acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  const int n_qb = S / BQ;
  // only query tiles at or below the diagonal see this key tile when causal
  // (the reference's start_qb)
  const int start_qb = causal ? k0 / BQ : 0;
  for (int t = start_qb; t < n_qb; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's reads of Q, dO, P, dS are done
    stage<D>(Qs, qb, st.q[1], q0, scale);
    stage<D>(dOs, ob, st.o[1], q0, 1.f);
    if (tid < BQ) {
      Ls[tid] = lse_bh[q0 + tid];
      Dls[tid] = dl_bh[q0 + tid];
    }
    __syncthreads();

    float s[COLS];
    float dp[COLS];
    scores<D>(Qs, dOs, Ks, Vs, r, j, s, dp);
    const int q_pos = q0 + r;
    const float l_row = Ls[r];
    const float d_row = Dls[r];
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int c = j + TPR * i;
      const float sv = (causal && q_pos < k0 + c) ? NEG_BIG : s[i];
      const float p = expf(sv - l_row);
      Ps[r * PSTR + c] = p;
      dSs[r * PSTR + c] = p * (dp[i] - d_row);
    }
    __syncthreads();

    // dV[kr] += P[:, kr]^T dO,  dK[kr] += dS[:, kr]^T (q * scale), kr = r
#pragma unroll 4
    for (int qr = 0; qr < BQ; ++qr) {
      const float p = Ps[qr * PSTR + r];
      const float ds = dSs[qr * PSTR + r];
      const float* o_row = dOs + qr * STR + j;
      const float* q_row = Qs + qr * STR + j;
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        dv_acc[e] = fmaf(p, o_row[TPR * e], dv_acc[e]);
        dk_acc[e] = fmaf(ds, q_row[TPR * e], dk_acc[e]);
      }
    }
  }

  const long long out_row = ((long long)(b * S + k0 + r) * H + h) * D;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    dk[out_row + j + TPR * e] = dk_acc[e];
    dv[out_row + j + TPR * e] = dv_acc[e];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int H, float scale, int causal, Strides st) {
  using L = Layout<D>;
  constexpr int STR = L::STR;
  constexpr int PSTR = L::PSTR;
  constexpr int DPT = D / TPR;           // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::TILE;
  float* Ks = dOs + L::TILE;
  float* Vs = Ks + L::TILE;
  float* dSs = Vs + L::TILE;

  const int tid = threadIdx.x;
  const int r = tid / TPR;   // query row within the tile
  const int j = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int q_pos = q0 + r;

  const float* qb = q + b * st.q[0] + h * st.q[2];
  const float* kb = k + b * st.k[0] + h * st.k[2];
  const float* vb = v + b * st.v[0] + h * st.v[2];
  const float* ob = dout + b * st.o[0] + h * st.o[2];

  stage<D>(Qs, qb, st.q[1], q0, scale);
  stage<D>(dOs, ob, st.o[1], q0, 1.f);
  const float l_row = lse[(long long)bh * S + q_pos];
  const float d_row = delta[(long long)bh * S + q_pos];

  float dq_acc[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) dq_acc[e] = 0.f;

  const int n_kb = S / BK;
  // key tiles up to the diagonal when causal (the reference's last_kb)
  const int last_kb = causal ? min((q0 + BQ + BK - 1) / BK, n_kb) : n_kb;
  float* ds_row = dSs + r * PSTR;
  for (int t = 0; t < last_kb; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K reads are done; Q is staged
    stage<D>(Ks, kb, st.k[1], k0, 1.f);
    stage<D>(Vs, vb, st.v[1], k0, 1.f);
    __syncthreads();

    float s[COLS];
    float dp[COLS];
    scores<D>(Qs, dOs, Ks, Vs, r, j, s, dp);
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int c = j + TPR * i;
      const float sv = (causal && q_pos < k0 + c) ? NEG_BIG : s[i];
      ds_row[c] = expf(sv - l_row) * (dp[i] - d_row);
    }
    __syncwarp();  // the row's four threads share one warp and one dS row

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float ds = ds_row[c];
      const float* k_row = Ks + c * STR + j;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        dq_acc[e] = fmaf(ds, k_row[TPR * e], dq_acc[e]);
    }
  }

  // dS was formed against q * scale, so the q cotangent carries the scale
  float* dq_row = dq + ((long long)(b * S + q_pos) * H + h) * D;
#pragma unroll
  for (int e = 0; e < DPT; ++e)
    dq_row[j + TPR * e] = dq_acc[e] * scale;
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, float scale,
                       int causal, const Strides& st, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<D>;
  const size_t smem = Layout<D>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BK, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, scale, causal,
      st);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, float scale, int causal,
                      const Strides& st, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<D>;
  const size_t smem = Layout<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), S, H, scale, causal, st);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H) {
  return B <= 0 || H <= 0 || S <= 0 || S % BQ != 0 || S % BK != 0 ||
         (long long)B * H > 65535;
}

Strides make_strides(const long long* s) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[3 + i];
    st.v[i] = s[6 + i];
    st.o[i] = s[9 + i];
  }
  return st;
}

}  // namespace

// Common arguments: q, k, v, dout (B, S, H, D) with element strides (batch,
// seq, head) given for each, in that order, and unit stride on D; lse and
// delta contiguous (B, H, S) f32; outputs contiguous (B, S, H, D) f32.
// Each returns the cudaError_t of its launch (0 on success) and does not
// synchronise.

// B2 (f32 only; bf16 takes pt_flash_attn_bwd_dkv_tc): dk and dv.
extern "C" int pt_flash_attn_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int H, int D, int causal, float scale, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const Strides st = make_strides(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                               scale, causal, st, cs);
  if (D == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                                scale, causal, st, cs);
  return (int)cudaErrorInvalidValue;
}

// B3 (f32 only; bf16 takes pt_flash_attn_bwd_dq_tc): dq.
extern "C" int pt_flash_attn_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int H, int D,
    int causal, float scale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, void* stream) {
  if (bad_shape(B, S, H)) return (int)cudaErrorInvalidValue;
  const long long s[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const Strides st = make_strides(s);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, scale,
                              causal, st, cs);
  if (D == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H, scale,
                               causal, st, cs);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
