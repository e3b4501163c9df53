// Flash-attention forward for Hopper (sm_90a), f32: kernel B1 of the port
// for f32 inputs (bf16 inputs take the tensor-core kernel in
// flash_attn_fwd_tc.cu).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_attn_fwd_kernel
// (launched by _flash_fwd_bh through pl.pallas_call). Same function: for
// each query row, an online softmax over key tiles,
//     S = (q * scale) . K^T           (f32)
//     causal: S = -1e30 where q_pos < k_pos, and the key loop stops at the
//             diagonal tile
//     m, l, acc rescaled by exp(m_prev - m_new) per tile
//     O = acc / max(l, 1e-30)         (stored as f32)
//     LSE = m + log(max(l, 1e-30))    (stored as (B, H, S) f32)
// with the reference's constants (m0 = -1e30, masked score -1e30, l floor
// 1e-30) and the scale applied to q in f32 before the product.
//
// What bounds it on the H100: one pass over q, k, v, o reads and writes
// 4*B*S*H*D elements, while the products take 4*B*H*S^2*D flops (half that
// when causal). In f32 at the GPT-medium prefill (B=4, H=16, S=512, D=64,
// causal) that is 33.7 MB (10.1 us at 3.35 TB/s) against 2.1 GFLOP (32.1 us
// at the 67 TFLOP/s of f32 outside the tensor cores): bound by operations.
//
// Why f32 stays on CUDA-core FMAs: TF32 tensor cores keep only about three
// decimal digits and would break the f32 correctness gates that rest on this
// kernel (kernel vs plain O within 2e-5, greedy tokens identical to the math
// path at full width, grads within 1e-3 relative L2 in chip_smoke.py's
// train_check). f32 is the port's correctness dtype; bf16, its hot path,
// runs on the tensor cores.
//
// Design. The TPU kernel runs one (BH, q-tile) grid step at a time and holds
// whole K/V rows in VMEM; here every (q-tile, b*h) pair is its own thread
// block, and blocks run in parallel on the 132 SMs, so S/64 * B*H blocks
// (512 at the prefill shape) fill the card without any cross-block state.
// A block stages its 64-row Q tile (pre-scaled) once and streams 64-row K
// and V tiles through shared memory; S and the softmax never leave the SM.
// Four threads own one query row: each computes 16 of the 64 scores of a
// tile, the row max and row sum are combined with two warp shuffles, and the
// row's probabilities go through a padded shared-memory row to the P.V
// product, where each thread keeps D/4 f32 accumulators in registers. Tiles
// are padded rows (no bank conflicts) and every product is a plain f32 FMA.
// The working set (66 KB at D=64, 115 KB at D=128) is above the 48 KB static
// limit, so the launcher raises the dynamic shared-memory limit first and
// returns any launch error.
//
// Inputs are (B, S, H, D) with any batch, sequence and head strides and a
// unit stride on D, so the strided q/k/v views that GPTAttention slices
// out of its fused qkv projection are read in place, with no copy.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per streamed tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;      // threads per query row (4)
constexpr int COLS = BK / TPR;         // scores per thread per tile (16)
constexpr float NEG_BIG = -1e30f;
constexpr float L_FLOOR = 1e-30f;

static_assert(TPR == 4, "the row reductions below shuffle over 4 lanes");

template <int D>
struct Layout {
  static constexpr int QK_STRIDE = D + 1;   // padded Q/K rows
  static constexpr int P_STRIDE = BK + 1;   // padded probability rows
  static constexpr int Q_FLOATS = BQ * QK_STRIDE;
  static constexpr int K_FLOATS = BK * QK_STRIDE;
  static constexpr int V_FLOATS = BK * D;
  static constexpr int P_FLOATS = BQ * P_STRIDE;
  static constexpr size_t BYTES =
      sizeof(float) * (size_t)(Q_FLOATS + K_FLOATS + V_FLOATS + P_FLOATS);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int H, float scale,
                 int causal, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh) {
  using L = Layout<D>;
  constexpr int DPT = D / TPR;           // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::Q_FLOATS;
  float* Vs = Ks + L::K_FLOATS;
  float* Ps = Vs + L::V_FLOATS;

  const int tid = threadIdx.x;
  const int r = tid / TPR;               // query row within the tile
  const int j = tid % TPR;               // this thread's slot in the row
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int q_pos = q0 + r;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int row = idx / D;
    const int col = idx % D;
    Qs[row * L::QK_STRIDE + col] =
        qb[(long long)(q0 + row) * q_ss + col] * scale;
  }

  float m = NEG_BIG;
  float l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int c = 0; c < DPT; ++c) acc[c] = 0.f;

  const int n_kb = S / BK;
  // key tiles up to the diagonal when causal (the reference's last_kb)
  const int last_kb = causal ? min((q0 + BQ + BK - 1) / BK, n_kb) : n_kb;
  const float* q_row = Qs + r * L::QK_STRIDE;
  float* p_row = Ps + r * L::P_STRIDE;

  for (int t = 0; t < last_kb; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K/V reads are done; Q is staged
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int row = idx / D;
      const int col = idx % D;
      const long long kr = (long long)(k0 + row);
      Ks[row * L::QK_STRIDE + col] = kb[kr * k_ss + col];
      Vs[row * D + col] = vb[kr * v_ss + col];
    }
    __syncthreads();

    float s[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_row[d];
#pragma unroll
      for (int i = 0; i < COLS; ++i)
        s[i] = fmaf(qd, Ks[(j + TPR * i) * L::QK_STRIDE + d], s[i]);
    }

    float m_cur = NEG_BIG;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      if (causal && q_pos < k0 + j + TPR * i) s[i] = NEG_BIG;
      m_cur = fmaxf(m_cur, s[i]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    const float correction = expf(m - m_new);

    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const float p = expf(s[i] - m_new);
      p_sum += p;
      p_row[j + TPR * i] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * correction + p_sum;
    m = m_new;
    __syncwarp();  // the row's four threads share one warp and one P row

#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[c] *= correction;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = p_row[c];
      const float* v_row = Vs + c * D + j;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] = fmaf(p, v_row[TPR * e], acc[e]);
    }
  }

  const float l_safe = fmaxf(l, L_FLOOR);
  float* o_row = o + ((long long)(b * S + q_pos) * H + h) * D;
#pragma unroll
  for (int e = 0; e < DPT; ++e) o_row[j + TPR * e] = acc[e] / l_safe;
  if (j == 0) lse[(long long)bh * S + q_pos] = m + logf(l_safe);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, float scale, int causal,
                   const long long* st, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  const size_t smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse),
      S, H, scale, causal, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8]);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (B, S, H, D) f32 with element strides (batch, seq, head) given
// for each and unit stride on D; o: contiguous (B, S, H, D) f32; lse:
// contiguous (B, H, S) f32. Returns the cudaError_t of the launch (0 on
// success). Does not synchronise.
extern "C" int pt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int H, int D, int causal, float scale, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S % BQ != 0 || S % BK != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, S, H, scale, causal, st, s);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, S, H, scale, causal, st, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* pt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
