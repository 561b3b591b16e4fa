// Hand-written Hopper (sm_90a) kernels for the F2P serve and measurement
// paths.
//
// Six kernels replace six Pallas TPU kernels of src/repro (the JAX
// reference):
//
//   quantize_packed_kernel    <- repro/kernels/f2p_quant.py::_quant_packed_kernel
//   dequantize_packed_kernel  <- repro/kernels/f2p_quant.py::_dequant_packed_kernel
//   attention_kernel<false>   <- repro/kernels/f2p_attention.py::_fused_kernel
//   attention_kernel<true>    <- repro/kernels/f2p_attention.py::_paged_kernel
//   counter_advance_kernel    <- repro/kernels/f2p_counter.py::_advance_kernel
//   counter_estimate_kernel   <- repro/kernels/f2p_counter.py::_estimate_kernel
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (repro_torch/kernels/cuda.py). Every entry takes the
// caller's stream, launches, and returns cudaGetLastError(). No entry
// allocates or synchronises.
//
// Exactness (the codec is held bitwise to the torch plain version and to
// the JAX reference): no --use_fast_math; the only rounding steps of the
// encode are written as __fmul_rn (absmax * f32(1/max)) and __fdiv_rn
// (x / scale), so no contraction or approximate divide can move a code;
// 2^n is built by bit assembly; half-up mantissa rounding goes through the
// exact fractional part u - floor(u).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Format constants, as repro_torch.kernels.f2p_quant._fmt_consts gives them.
struct F2PConsts {
  int nu, h, sgn, vmax, v_sub, v_top, bias, is_signed, n_bits;
};

// ---------------------------------------------------------------------------
// Shared device helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ float exp2i(int n) {
  // exact 2^n for n in [-126, 127]
  return __int_as_float((n + 127) << 23);
}

__device__ __forceinline__ int esize_of(int v, int h) {
  // floor(log2(v+1)) as exact thresholds: grows by one at v = 2^j - 1
  int es = 0;
  for (int j = 1; j < (1 << h); ++j) es += (v >= ((1 << j) - 1));
  return es;
}

__device__ __forceinline__ uint32_t f2p_encode(float y, const F2PConsts& f) {
  const int nu = f.nu, h = f.h, sgn = f.sgn, bias = f.bias;
  const bool neg = f.is_signed && signbit(y);
  const float mag = fabsf(y);
  const int bexp = (__float_as_int(mag) >> 23) & 0xFF;
  int v = min(max(sgn * (bexp - 127 - bias), 0), f.vmax - 1);
  if (bexp == 0) v = f.v_sub;  // zero and f32 subnormals
  const int es = esize_of(v, h);
  const int mbits = nu - h - es;
  const bool is_sub = v == f.v_sub;
  const int e_val = sgn * v;
  const int exp_lo = is_sub ? e_val + bias + 1 : e_val + bias;
  const int lead = is_sub ? 0 : 1;
  float u = __fmul_rn(mag, exp2i(mbits - exp_lo));
  u = __fsub_rn(u, (float)(lead << mbits));
  u = fminf(u, 2.0f * (float)(1 << mbits));
  const float mf = floorf(u);
  int m = (int)__fadd_rn(mf, (__fsub_rn(u, mf) >= 0.5f) ? 1.0f : 0.0f);
  m = max(m, 0);
  const bool ovf = m >= (1 << mbits);
  const bool at_top = v == f.v_top;
  // overflow hops one bucket toward larger magnitudes; the top clamps
  const int v2 = (ovf && !at_top) ? v + sgn : v;
  const int es2 = esize_of(v2, h);
  const int mbits2 = nu - h - es2;
  const int m2 = ovf ? (at_top ? (1 << mbits2) - 1 : 0) : m;
  const int efield = v2 - ((1 << es2) - 1);
  uint32_t payload = (uint32_t)((es2 << (nu - h)) | (efield << mbits2) | m2);
  if (neg) payload |= 1u << nu;
  return payload;
}

__device__ __forceinline__ float f2p_decode(uint32_t code, const F2PConsts& f) {
  const int nu = f.nu, h = f.h;
  const int c = (int)code;
  const int payload = c & ((1 << nu) - 1);
  const int es = (payload >> (nu - h)) & ((1 << h) - 1);
  const int mbits = nu - h - es;
  const int efield = (payload >> mbits) & ((1 << es) - 1);
  const int v = ((1 << es) - 1) + efield;
  const int m = payload & ((1 << mbits) - 1);
  const bool is_sub = v == f.v_sub;
  const int e_val = f.sgn * v;
  const int exp_lo = is_sub ? e_val + f.bias + 1 : e_val + f.bias;
  const int lead = is_sub ? 0 : 1;
  const float val = __fmul_rn((float)((lead << mbits) + m), exp2i(exp_lo - mbits));
  return (f.is_signed && ((c >> nu) & 1)) ? -val : val;
}

// field i (n_bits wide) of a little-endian packed row
__device__ __forceinline__ uint32_t get_field(const uint32_t* __restrict__ row,
                                              int i, int nb) {
  const int o = i * nb, w0 = o >> 5, s = o & 31;
  uint32_t lo = row[w0] >> s;
  if (s + nb > 32) lo |= row[w0 + 1] << (32 - s);
  return nb < 32 ? (lo & ((1u << nb) - 1u)) : lo;
}

__device__ __forceinline__ float pow2_round_up(float s) {
  const uint32_t b = __float_as_uint(s);
  uint32_t e = (b >> 23) & 0xFFu;
  if (b & 0x7FFFFFu) e += 1u;
  e = min(max(e, 1u), 254u);
  return __uint_as_float(e << 23);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// quantize_packed: x [rows, cols] -> words [rows, W] u32, scales [rows, cols/block]
// One CTA per row; warp w takes scale blocks w, w+nwarps, ...: warp-shuffle
// absmax, per-lane encode into shared memory. Then each output word is
// assembled by one thread from the fields that overlap it, so any n_bits in
// 1..16 and any block width pack correctly.
// ---------------------------------------------------------------------------
template <typename TIn>
__global__ void quantize_packed_kernel(const TIn* __restrict__ x,
                                       uint32_t* __restrict__ words,
                                       float* __restrict__ scales, int cols,
                                       int block, int W, F2PConsts f,
                                       float inv_max, int pow2) {
  extern __shared__ uint32_t codes[];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nblk = cols / block;
  const TIn* xr = x + (size_t)row * cols;
  for (int bi = warp; bi < nblk; bi += nwarps) {
    const TIn* xb = xr + (size_t)bi * block;
    float amax = 0.0f;
    for (int i = lane; i < block; i += 32) amax = fmaxf(amax, fabsf(to_f32(xb[i])));
    for (int off = 16; off; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    float scale = __fmul_rn(amax, inv_max);
    if (pow2) scale = pow2_round_up(scale > 0.0f ? scale : 1.0f);
    scale = amax > 0.0f ? scale : 1.0f;
    if (lane == 0) scales[(size_t)row * nblk + bi] = scale;
    for (int i = lane; i < block; i += 32)
      codes[bi * block + i] = f2p_encode(__fdiv_rn(to_f32(xb[i]), scale), f);
  }
  __syncthreads();
  const int nb = f.n_bits;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int b0 = w * 32;
    const int i0 = b0 / nb, i1 = min((b0 + 31) / nb, cols - 1);
    uint32_t word = 0;
    for (int i = i0; i <= i1; ++i) {
      const int o = i * nb - b0;
      word |= o >= 0 ? (codes[i] << o) : (codes[i] >> (-o));
    }
    words[(size_t)row * W + w] = word;
  }
}

// ---------------------------------------------------------------------------
// dequantize_packed: one thread per output element (grid-stride).
// ---------------------------------------------------------------------------
template <typename TOut>
__global__ void dequantize_packed_kernel(const uint32_t* __restrict__ words,
                                         const float* __restrict__ scales,
                                         TOut* __restrict__ out, long long total,
                                         int cols, int block, int W, F2PConsts f) {
  const int nblk = cols / block;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / cols;
    const int j = (int)(idx - row * cols);
    const uint32_t c = get_field(words + row * W, j, f.n_bits);
    store(out + idx, __fmul_rn(f2p_decode(c, f), scales[row * nblk + j / block]));
  }
}

// ---------------------------------------------------------------------------
// attention over packed KV, dense ([B, S, K, W]) or paged ([P, T, K, W]
// slabs through a [B, maxp] page table). One CTA per (batch row, kv head);
// the R = G*Sq folded query rows live in shared memory. Per kv tile:
// decode K into f32 shared memory, fp32 dot products, mask, online-softmax
// update (the reference's -inf-guarded _online_step), decode V into the
// same buffer, acc += p V. Both addressing modes run the same tile loop, so
// paged == dense-over-gathered-pages bitwise. Tiles wholly past a row's
// kv_len are skipped: with a finite running max such a tile leaves
// (acc, m, l) bitwise unchanged (p = 0, corr = exp(0) = 1).
// ---------------------------------------------------------------------------
constexpr int kAttnThreads = 256;

struct AttnArgs {
  const float* q3;      // [B, K, R, hd]
  const uint32_t* kw;   // dense [B, S, K, Wk] | paged [P, T, K, Wk]
  const float* ks;      // same leading dims, last dim 1
  const uint32_t* vw;
  const float* vs;
  const int* pages;     // paged: [B, maxp]
  const int* lens;      // [B, 2] (kv_len, q_offset)
  float* out;           // [B, K, R, hd]
  int K, R, hd, Wk, Wv;
  int S;                // logical per-row length (paged: maxp * T)
  int T, P, maxp;       // paged only
  int sq, causal, tile, nt;
  float scale;
  F2PConsts fk, fv;
};

template <bool PAGED>
__device__ __forceinline__ long long kv_row(const AttnArgs& a, int b, int h, int kpos) {
  if (PAGED) {
    int pid = a.pages[(long long)b * a.maxp + kpos / a.T];
    pid = min(max(pid, 0), a.P - 1);
    return ((long long)pid * a.T + kpos % a.T) * a.K + h;
  }
  return ((long long)b * a.S + kpos) * a.K + h;
}

// Stage one kv tile in three passes separated by barriers: (1) each
// position's row index and scale, (2) the tile's packed words, loaded with
// independent coalesced reads (one long dependent chain per element was
// latency bound), (3) unpack + decode + scale from shared memory into the
// f32 tile buf [tile, hd+1]. Positions >= S read as zero words x scale 0.
template <bool PAGED>
__device__ __forceinline__ void decode_tile(const AttnArgs& a,
                                            const uint32_t* __restrict__ w,
                                            const float* __restrict__ sc, int W,
                                            const F2PConsts& f, int b, int h,
                                            int j, float* buf, uint32_t* raw,
                                            float* rsc, long long* rrow) {
  const int hd = a.hd, ld = hd + 1, tile = a.tile;
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    const int kpos = j * tile + p;
    const long long row = kpos < a.S ? kv_row<PAGED>(a, b, h, kpos) : -1;
    rrow[p] = row;
    rsc[p] = row >= 0 ? sc[row] : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tile * W; e += blockDim.x) {
    const int p = e / W;
    const long long row = rrow[p];
    raw[e] = row >= 0 ? w[row * W + (e - p * W)] : 0u;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tile * hd; e += blockDim.x) {
    const int p = e / hd, d = e - p * hd;
    buf[p * ld + d] =
        __fmul_rn(f2p_decode(get_field(raw + p * W, d, f.n_bits), f), rsc[p]);
  }
}

template <bool PAGED>
__global__ void attention_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / a.K, h = blockIdx.x % a.K;
  const int R = a.R, hd = a.hd, tile = a.tile, ld = hd + 1;
  float* kv = smem;                  // [tile, hd+1]
  float* qs = kv + tile * ld;        // [R, hd]
  float* acc = qs + R * hd;          // [R, hd]
  float* ss = acc + R * hd;          // [R, tile] scores, then p
  float* mrow = ss + R * tile;       // [R]
  float* lrow = mrow + R;            // [R]
  float* corr = lrow + R;            // [R]
  float* rsc = corr + R;             // [tile] staged scales
  long long* rrow = (long long*)(((uintptr_t)(rsc + tile) + 7) & ~(uintptr_t)7);
  uint32_t* raw = (uint32_t*)(rrow + tile);   // [tile, max(Wk, Wv)] words
  const float* qg = a.q3 + ((long long)b * a.K + h) * R * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
    qs[i] = qg[i];
    acc[i] = 0.0f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.0f;
  }
  const int kvlen = min(a.lens[2 * b], a.S), qoff = a.lens[2 * b + 1];
  const int nt = min(a.nt, kvlen > 0 ? (kvlen + tile - 1) / tile : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int j = 0; j < nt; ++j) {
    __syncthreads();
    decode_tile<PAGED>(a, a.kw, a.ks, a.Wk, a.fk, b, h, j, kv, raw, rsc, rrow);
    __syncthreads();
    for (int i = threadIdx.x; i < R * tile; i += blockDim.x) {
      const int r = i / tile, t = i - r * tile;
      const int kpos = j * tile + t;
      const float* qr = qs + r * hd;
      const float* kr = kv + t * ld;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      bool valid = kpos < kvlen;
      if (a.causal) valid = valid && (kpos <= qoff + r % a.sq);
      ss[i] = valid ? dot * a.scale : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < R; r += nwarps) {
      float* sr = ss + r * tile;
      float mx = -INFINITY;
      for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sr[t]);
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      const float safe_m = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
      for (int t = lane; t < tile; t += 32) {
        const float p = expf(sr[t] - safe_m);
        sr[t] = p;
        sum += p;
      }
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = isfinite(m_old) ? expf(m_old - safe_m) : 0.0f;
        corr[r] = c;
        lrow[r] = lrow[r] * c + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
    decode_tile<PAGED>(a, a.vw, a.vs, a.Wv, a.fv, b, h, j, kv, raw, rsc, rrow);
    __syncthreads();
    for (int i = threadIdx.x; i < R * hd; i += blockDim.x) {
      const int r = i / hd, d = i - r * hd;
      const float* pr = ss + r * tile;
      float pv = 0.0f;
      for (int t = 0; t < tile; ++t) pv = fmaf(pr[t], kv[t * ld + d], pv);
      acc[i] = acc[i] * corr[r] + pv;
    }
  }
  __syncthreads();
  float* og = a.out + ((long long)b * a.K + h) * R * hd;
  for (int i = threadIdx.x; i < R * hd; i += blockDim.x)
    og[i] = acc[i] / fmaxf(lrow[i / hd], 1e-37f);
}

// ---------------------------------------------------------------------------
// counter_advance: the stochastic advance of F2P grid counters (B9)
//
// One thread per cell of the flattened state. Each of `sweeps` sweeps
// crosses the run of p = 1 states in one step, then draws the geometric
// sojourn ceil(log u / log(1-p)) of the current state and advances if the
// remaining budget covers it (repro_torch.kernels.f2p_counter._sweep). The
// uniforms are not streamed in: u = hash(seed, sweep0 + t, lane) is
// computed in registers, the same counter-based stream hash_uniforms builds
// for the plain version. Bound by bytes (state + budget in, state +
// leftover out: 16 B per cell); the p/run/logq tables (<= 768 KiB) stay in
// L2 and go through the read-only cache. A cell whose budget is spent
// stops: a sweep with rem == 0 changes nothing, so the result is the same.
//
// Exactness against torch on the card: logf (not __logf), a correctly
// rounded divide, no --use_fast_math; the uniform's arithmetic is exact.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t sweep,
                                              uint32_t lane) {
  const uint32_t x = fmix32(lane ^ (sweep * 0x9E3779B1u) ^ seed);
  // 24 exact bits + half an ulp, times 2^-24: strictly inside (0, 1)
  return __fmul_rn(__fadd_rn((float)(x >> 8), 0.5f), 5.9604644775390625e-8f);
}

__global__ void counter_advance_kernel(const int* __restrict__ state_in,
                                       const float* __restrict__ budget,
                                       int* __restrict__ state_out,
                                       float* __restrict__ left,
                                       const float* __restrict__ p_lut,
                                       const float* __restrict__ run_lut,
                                       const float* __restrict__ logq_lut,
                                       long long n, int kmax, uint32_t seed,
                                       uint32_t sweep0, int sweeps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s = state_in[i];
  float rem = budget[i];
  for (int t = 0; t < sweeps && rem > 0.f; ++t) {
    const float run = fminf(rem, __ldg(run_lut + s));
    s += (int)run;  // truncation, as torch's f32 -> int32
    rem = __fsub_rn(rem, run);
    const float pk = __ldg(p_lut + s);
    const float u = hash_uniform(seed, sweep0 + (uint32_t)t, (uint32_t)i);
    float need = ceilf(__fdiv_rn(logf(u), __ldg(logq_lut + s)));
    // p = 1 and p = 0 carry logq = 0: the quotient is +-inf and is
    // overridden here, before the maximum (the reference's order)
    if (pk >= 1.f) need = 1.f;
    if (pk <= 0.f) need = INFINITY;
    need = fmaxf(need, 1.f);
    if (need <= rem) {
      s = min(s + 1, kmax);
      rem = __fsub_rn(rem, need);
    } else {
      rem = 0.f;  // no advance within this budget; a saturated cell parks
    }
  }
  state_out[i] = s;
  left[i] = rem;
}

// ---------------------------------------------------------------------------
// counter_estimate: L[state], one thread per cell (B10). Bound by bytes
// (4 B of state in, 4 B of estimate out); the grid stays in L2.
// ---------------------------------------------------------------------------
__global__ void counter_estimate_kernel(const int* __restrict__ state,
                                        const float* __restrict__ grid,
                                        float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(grid + state[i]);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
extern "C" {

const char* f2p_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }

int f2p_quantize_packed(const void* x, int x_bf16, uint32_t* words, float* scales,
                        int rows, int cols, int block, int W, F2PConsts f,
                        float inv_max, int pow2, cudaStream_t stream) {
  const int nblk = cols / block;
  const int threads = 32 * min(4, max(1, nblk));
  const size_t smem = (size_t)cols * sizeof(uint32_t);
  if (x_bf16) {
    auto k = quantize_packed_kernel<__nv_bfloat16>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k<<<rows, threads, smem, stream>>>((const __nv_bfloat16*)x, words, scales, cols,
                                        block, W, f, inv_max, pow2);
  } else {
    auto k = quantize_packed_kernel<float>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k<<<rows, threads, smem, stream>>>((const float*)x, words, scales, cols, block,
                                        W, f, inv_max, pow2);
  }
  return (int)cudaGetLastError();
}

int f2p_dequantize_packed(const uint32_t* words, const float* scales, void* out,
                          int out_bf16, int rows, int cols, int block, int W,
                          F2PConsts f, cudaStream_t stream) {
  const long long total = (long long)rows * cols;
  const int threads = 256;
  const int grid = (int)min((total + threads - 1) / threads, (long long)1 << 20);
  if (out_bf16)
    dequantize_packed_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        words, scales, (__nv_bfloat16*)out, total, cols, block, W, f);
  else
    dequantize_packed_kernel<float><<<grid, threads, 0, stream>>>(
        words, scales, (float*)out, total, cols, block, W, f);
  return (int)cudaGetLastError();
}

size_t f2p_attention_smem(int R, int hd, int tile, int W) {
  // kv tile, q, acc, scores, (m, l, corr), staged scales, then 8-aligned
  // row indices and staged words
  size_t fl = (size_t)tile * (hd + 1) + 2 * (size_t)R * hd + (size_t)R * tile +
              3 * (size_t)R + tile;
  return ((fl * sizeof(float) + 7) & ~(size_t)7) + (size_t)tile * 8 +
         (size_t)tile * W * sizeof(uint32_t);
}

int f2p_attention(const float* q3, const uint32_t* kw, const float* ks,
                  const uint32_t* vw, const float* vs, const int* pages,
                  const int* lens, float* out, int B, int K, int R, int hd,
                  int Wk, int Wv, int S, int T, int P, int maxp, int sq,
                  int causal, int tile, F2PConsts fk, F2PConsts fv, float scale,
                  cudaStream_t stream) {
  AttnArgs a;
  a.q3 = q3; a.kw = kw; a.ks = ks; a.vw = vw; a.vs = vs;
  a.pages = pages; a.lens = lens; a.out = out;
  a.K = K; a.R = R; a.hd = hd; a.Wk = Wk; a.Wv = Wv;
  a.S = S; a.T = T; a.P = P; a.maxp = maxp;
  a.sq = sq; a.causal = causal; a.tile = tile;
  a.nt = (S + tile - 1) / tile;
  a.scale = scale; a.fk = fk; a.fv = fv;
  const size_t smem = f2p_attention_smem(R, hd, tile, max(Wk, Wv));
  static bool opted_in = false;   // once per process: allow up to 227 KB
  if (!opted_in) {
    cudaFuncSetAttribute(attention_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    cudaFuncSetAttribute(attention_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    opted_in = true;
  }
  if (pages)
    attention_kernel<true><<<B * K, kAttnThreads, smem, stream>>>(a);
  else
    attention_kernel<false><<<B * K, kAttnThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int f2p_counter_advance(const int* state, const float* budget, int* state_out,
                        float* left, const float* p_lut, const float* run_lut,
                        const float* logq_lut, long long n, int kmax,
                        uint32_t seed, uint32_t sweep0, int sweeps,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  counter_advance_kernel<<<(unsigned)grid, threads, 0, stream>>>(
      state, budget, state_out, left, p_lut, run_lut, logq_lut, n, kmax, seed,
      sweep0, sweeps);
  return (int)cudaGetLastError();
}

int f2p_counter_estimate(const int* state, const float* grid_lut, float* out,
                         long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  counter_estimate_kernel<<<(unsigned)grid, threads, 0, stream>>>(
      state, grid_lut, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
