// Hand-written Hopper (sm_90a) kernels for the F2P serve, measurement and
// training paths.
//
// Ten kernels replace the ten Pallas TPU kernels of src/repro (the JAX
// reference):
//
//   quantize_packed_kernel    <- repro/kernels/f2p_quant.py::_quant_packed_kernel
//   dequantize_packed_kernel  <- repro/kernels/f2p_quant.py::_dequant_packed_kernel
//   quantize_kernel           <- repro/kernels/f2p_quant.py::_quant_kernel
//   dequantize_kernel         <- repro/kernels/f2p_quant.py::_dequant_kernel
//   attention_kernel<false>   <- repro/kernels/f2p_attention.py::_fused_kernel
//   attention_kernel<true>    <- repro/kernels/f2p_attention.py::_paged_kernel
//   counter_advance_kernel    <- repro/kernels/f2p_counter.py::_advance_kernel
//   counter_estimate_kernel   <- repro/kernels/f2p_counter.py::_estimate_kernel
//   dequant_matmul_kernel<UnpackedW>  <- repro/kernels/f2p_matmul.py::_kernel
//   dequant_matmul_kernel<PackedW>    <- repro/kernels/f2p_matmul.py::_packed_kernel
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
  // not fminf, which drops a NaN: torch.minimum keeps it, and a NaN u
  // then converts to m = 0 as in the plain version
  const float cap = 2.0f * (float)(1 << mbits);
  u = u > cap ? cap : u;
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

// A scale block's scale from its lane's absmax and NaN flag, reduced over
// the warp: absmax * f32(1/max), rounded up to a power of two in pow2 mode;
// 1 for an all-zero block and for a block holding a NaN (the plain
// version's absmax is NaN there, and NaN > 0 is false; fmaxf alone would
// drop the NaN and scale by the finite elements).
__device__ __forceinline__ float block_scale(float amax, bool nan,
                                             float inv_max, int pow2) {
  for (int off = 16; off; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (__any_sync(0xffffffffu, nan)) return 1.0f;
  float scale = __fmul_rn(amax, inv_max);
  if (pow2) scale = pow2_round_up(scale > 0.0f ? scale : 1.0f);
  return amax > 0.0f ? scale : 1.0f;
}

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
    bool nan = false;
    for (int i = lane; i < block; i += 32) {
      const float a = fabsf(to_f32(xb[i]));
      amax = fmaxf(amax, a);
      nan |= a != a;
    }
    const float scale = block_scale(amax, nan, inv_max, pow2);
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
// quantize (unpacked): x [rows, cols] -> codes [rows, cols] uint8 (n <= 8) or
// uint16, scales [rows, cols/block] (B5). Bound by bytes: x is read once
// from device memory, 1 or 2 bytes per element and 4 per block go out.
// One warp per scale block, grid-stride over the rows * nblk blocks (block
// index == scale index, so the scales are written in order). With VEC
// (block == 128, 16-byte aligned rows) lane l owns elements 4l..4l+3: one
// 16-byte (f32) or 8-byte (bf16) load and one 4- or 8-byte store of its
// four codes, so a warp moves its block in one instruction each way.
// Otherwise lane l takes elements l, l+32, ...: a block of at most 128
// stays in registers between the shuffle absmax and the encode, a wider
// one is read twice (the second time from L1/L2). The absmax is a max, so
// the element order does not change a bit of the result.
// ---------------------------------------------------------------------------
constexpr int kQuantVals = 4;   // values a lane keeps in registers

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(uint8_t* p, const uint32_t* c) {
  *reinterpret_cast<uint32_t*>(p) = c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24);
}
__device__ __forceinline__ void store4(uint16_t* p, const uint32_t* c) {
  *reinterpret_cast<uint2*>(p) = make_uint2(c[0] | (c[1] << 16), c[2] | (c[3] << 16));
}

template <typename TIn, typename TCode, bool VEC>
__global__ void quantize_kernel(const TIn* __restrict__ x,
                                TCode* __restrict__ codes,
                                float* __restrict__ scales, long long nblocks,
                                int block, F2PConsts f, float inv_max,
                                int pow2) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const bool in_regs = VEC || block <= 32 * kQuantVals;
  for (long long wb = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       wb < nblocks; wb += nwarps) {
    const TIn* xb = x + wb * block;
    TCode* cb = codes + wb * block;
    float v[kQuantVals];
    float amax = 0.0f;
    bool nan = false;
    if (VEC) {
      load4(xb + 4 * lane, v);
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        amax = fmaxf(amax, fabsf(v[k]));
        nan |= v[k] != v[k];
      }
    } else if (in_regs) {
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        const int i = lane + 32 * k;
        v[k] = i < block ? to_f32(xb[i]) : 0.0f;
        amax = fmaxf(amax, fabsf(v[k]));
        nan |= v[k] != v[k];
      }
    } else {
      for (int i = lane; i < block; i += 32) {
        const float a = fabsf(to_f32(xb[i]));
        amax = fmaxf(amax, a);
        nan |= a != a;
      }
    }
    const float scale = block_scale(amax, nan, inv_max, pow2);
    if (lane == 0) scales[wb] = scale;
    if (VEC) {
      uint32_t c[kQuantVals];
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) c[k] = f2p_encode(__fdiv_rn(v[k], scale), f);
      store4(cb + 4 * lane, c);
    } else if (in_regs) {
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        const int i = lane + 32 * k;
        if (i < block) cb[i] = (TCode)f2p_encode(__fdiv_rn(v[k], scale), f);
      }
    } else {
      for (int i = lane; i < block; i += 32)
        cb[i] = (TCode)f2p_encode(__fdiv_rn(to_f32(xb[i]), scale), f);
    }
  }
}

// ---------------------------------------------------------------------------
// dequantize (unpacked): codes [rows, cols] uint8/uint16 + scales -> values
// (B6). Bound by bytes. Grid-stride; element idx belongs to scale
// idx / block because cols is a multiple of block. With VEC (block % 4 == 0
// and aligned pointers) a thread takes 4 consecutive codes, which share one
// scale: one 4- or 8-byte load of codes, one 16-byte (f32) or 8-byte (bf16)
// store. Otherwise one element per thread.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_codes4(const uint8_t* p, uint32_t* c) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  c[0] = w & 0xFFu; c[1] = (w >> 8) & 0xFFu; c[2] = (w >> 16) & 0xFFu; c[3] = w >> 24;
}
__device__ __forceinline__ void load_codes4(const uint16_t* p, uint32_t* c) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  c[0] = w.x & 0xFFFFu; c[1] = w.x >> 16; c[2] = w.y & 0xFFFFu; c[3] = w.y >> 16;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<uint32_t*>(&a),
                                            *reinterpret_cast<uint32_t*>(&b));
}

template <typename TCode, typename TOut, bool VEC>
__global__ void dequantize_kernel(const TCode* __restrict__ codes,
                                  const float* __restrict__ scales,
                                  TOut* __restrict__ out, long long total,
                                  int block, F2PConsts f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (VEC) {
    for (long long q = t0; 4 * q < total; q += stride) {
      const long long idx = 4 * q;
      const float s = __ldg(scales + idx / block);
      uint32_t c[4];
      float v[4];
      load_codes4(codes + idx, c);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(f2p_decode(c[k], f), s);
      store4(out + idx, v);
    }
  } else {
    for (long long idx = t0; idx < total; idx += stride)
      store(out + idx, __fmul_rn(f2p_decode((uint32_t)codes[idx], f),
                                 __ldg(scales + idx / block)));
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
// dequant_matmul: y[M, N] f32 = x[M, K] (f32 or bf16) @ W, W[k, n] =
// decode(code[k, n]) * scales[k / block, n] (B8 from uint8 / uint16 codes,
// B7 from each K-row's bit-packed words). f32 only: every W element is the
// correctly rounded f32 product decode * scale, as the plain version's, and
// the sum is f32 FMAs (no TF32, no bf16 tensor cores).
//
// At a decode batch (M = 8) the kernel is bound by the weight stream
// (n_bits/8 bytes per weight + 4/block for the scales), at a prefill batch
// (M = 2048) by its f32 operations. A simple SIMT design: one CTA of 256
// threads per (BM x 128) output tile, BM = 8 * TM covering M (so a decode
// batch does not pad to 128 rows); per K step of 32 it stages the x tile
// (as f32, k-major) and the decoded, scaled W tile in shared memory, and
// warp w / lane l accumulate rows w + 8i (i < TM) x columns l + 32j (j < 4)
// in registers. Formats of at most 10 bits decode through a table in
// shared memory built with f2p_decode (the same values bit for bit), wider
// ones call f2p_decode per element. When the output tiles alone leave the
// card idle (decode shapes), K is split across `splits` CTAs, each writing
// its partial tile to part[split]; sum_splits_kernel then adds the
// partials in split order, so the result does not depend on scheduling.
// Later: wgmma, TMA staging and a pipelined packed stream.
// ---------------------------------------------------------------------------
constexpr int kMmBN = 128, kMmBK = 32, kMmThreads = 256, kMmLut = 1024;

template <typename TCode>
struct UnpackedW {
  const TCode* __restrict__ codes;
  int N;
  __device__ __forceinline__ uint32_t code(int k, int n) const {
    return (uint32_t)codes[(size_t)k * N + n];
  }
};

struct PackedW {
  const uint32_t* __restrict__ words;
  int W, nb;
  __device__ __forceinline__ uint32_t code(int k, int n) const {
    return get_field(words + (size_t)k * W, n, nb);
  }
};

template <typename TIn, typename WSrc, int TM>
__global__ void __launch_bounds__(kMmThreads)
dequant_matmul_kernel(const TIn* __restrict__ x, WSrc w,
                      const float* __restrict__ scales,
                      float* __restrict__ part, int M, int N, int K, int block,
                      int k_chunk, F2PConsts f) {
  constexpr int BM = 8 * TM;
  __shared__ float xs[kMmBK][BM + 1];     // x tile, k-major (+1: no bank clash)
  __shared__ float ws[kMmBK][kMmBN];      // decoded, scaled W tile
  __shared__ float lut[kMmLut];
  const bool use_lut = f.n_bits <= 10;
  if (use_lut)
    for (int c = threadIdx.x; c < (1 << f.n_bits); c += kMmThreads)
      lut[c] = f2p_decode((uint32_t)c, f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kMmBN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_chunk, ke = min(K, kb + k_chunk);
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = kb; k0 < ke; k0 += kMmBK) {
    __syncthreads();   // the table is built / the last tile is consumed
    for (int e = threadIdx.x; e < BM * kMmBK; e += kMmThreads) {
      const int m = e / kMmBK, kk = e - m * kMmBK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < ke) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < kMmBK * kMmBN; e += kMmThreads) {
      const int kk = e / kMmBN, n = e - kk * kMmBN;
      const int gk = k0 + kk, gn = n0 + n;
      float v = 0.0f;
      if (gk < ke && gn < N) {
        const uint32_t c = w.code(gk, gn);
        // the table covers the code's n_bits, which is all f2p_decode reads
        const float d = use_lut ? lut[c & ((1u << f.n_bits) - 1u)] : f2p_decode(c, f);
        v = __fmul_rn(d, __ldg(scales + (size_t)(gk / block) * N + gn));
      }
      ws[kk][n] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kMmBK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xs[kk][warp + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
  float* out = part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + warp + 8 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + lane + 32 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// y = part[0] + part[1] + ... in split order (deterministic)
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ y, long long mn,
                                  int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int p = 1; p < splits; ++p) s += part[p * mn + i];
    y[i] = s;
  }
}

template <typename TIn, typename WSrc>
static void launch_matmul(const void* x, WSrc w, const float* scales, float* part,
                          int M, int N, int K, int block, int bm, int k_chunk,
                          int splits, F2PConsts f, cudaStream_t stream) {
  const dim3 grid((N + kMmBN - 1) / kMmBN, (M + bm - 1) / bm, splits);
  const TIn* xp = (const TIn*)x;
  switch (bm) {
    case 8:
      dequant_matmul_kernel<TIn, WSrc, 1><<<grid, kMmThreads, 0, stream>>>(
          xp, w, scales, part, M, N, K, block, k_chunk, f);
      break;
    case 16:
      dequant_matmul_kernel<TIn, WSrc, 2><<<grid, kMmThreads, 0, stream>>>(
          xp, w, scales, part, M, N, K, block, k_chunk, f);
      break;
    case 32:
      dequant_matmul_kernel<TIn, WSrc, 4><<<grid, kMmThreads, 0, stream>>>(
          xp, w, scales, part, M, N, K, block, k_chunk, f);
      break;
    case 64:
      dequant_matmul_kernel<TIn, WSrc, 8><<<grid, kMmThreads, 0, stream>>>(
          xp, w, scales, part, M, N, K, block, k_chunk, f);
      break;
    default:
      dequant_matmul_kernel<TIn, WSrc, 16><<<grid, kMmThreads, 0, stream>>>(
          xp, w, scales, part, M, N, K, block, k_chunk, f);
  }
}

template <typename WSrc>
static void launch_matmul_in(int x_bf16, const void* x, WSrc w,
                             const float* scales, float* part, int M, int N,
                             int K, int block, int bm, int k_chunk, int splits,
                             F2PConsts f, cudaStream_t stream) {
  if (x_bf16)
    launch_matmul<__nv_bfloat16>(x, w, scales, part, M, N, K, block, bm,
                                 k_chunk, splits, f, stream);
  else
    launch_matmul<float>(x, w, scales, part, M, N, K, block, bm, k_chunk,
                         splits, f, stream);
}

// ---------------------------------------------------------------------------
// B5 / B6 launchers: the vectorized kernels where the block and the
// pointers' alignment allow, the per-element ones otherwise
// ---------------------------------------------------------------------------
template <typename TIn, typename TCode>
static void launch_quantize(const void* x, void* codes, float* scales,
                            long long nblocks, int block, F2PConsts f,
                            float inv_max, int pow2, cudaStream_t stream) {
  const int threads = 256;   // 8 warps, one scale block each per pass
  const int grid = (int)min((nblocks + 7) / 8, (long long)1 << 20);
  const bool vec = block == 128 && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)codes % 8 == 0);
  if (vec)
    quantize_kernel<TIn, TCode, true><<<grid, threads, 0, stream>>>(
        (const TIn*)x, (TCode*)codes, scales, nblocks, block, f, inv_max, pow2);
  else
    quantize_kernel<TIn, TCode, false><<<grid, threads, 0, stream>>>(
        (const TIn*)x, (TCode*)codes, scales, nblocks, block, f, inv_max, pow2);
}

template <typename TCode, typename TOut>
static void launch_dequantize(const void* codes, const float* scales, void* out,
                              long long total, int block, F2PConsts f,
                              cudaStream_t stream) {
  const int threads = 256;
  const bool vec = block % 4 == 0 && ((uintptr_t)codes % 8 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const long long work = vec ? total / 4 : total;
  const int grid = (int)min((work + threads - 1) / threads, (long long)1 << 20);
  if (vec)
    dequantize_kernel<TCode, TOut, true><<<grid, threads, 0, stream>>>(
        (const TCode*)codes, scales, (TOut*)out, total, block, f);
  else
    dequantize_kernel<TCode, TOut, false><<<grid, threads, 0, stream>>>(
        (const TCode*)codes, scales, (TOut*)out, total, block, f);
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

int f2p_quantize(const void* x, int x_bf16, void* codes, int code_bytes,
                 float* scales, long long rows, int cols, int block,
                 F2PConsts f, float inv_max, int pow2, cudaStream_t stream) {
  const long long nblocks = rows * (cols / block);
  if (nblocks <= 0) return 0;
  if (x_bf16 && code_bytes == 1)
    launch_quantize<__nv_bfloat16, uint8_t>(x, codes, scales, nblocks, block, f,
                                            inv_max, pow2, stream);
  else if (x_bf16)
    launch_quantize<__nv_bfloat16, uint16_t>(x, codes, scales, nblocks, block, f,
                                             inv_max, pow2, stream);
  else if (code_bytes == 1)
    launch_quantize<float, uint8_t>(x, codes, scales, nblocks, block, f, inv_max,
                                    pow2, stream);
  else
    launch_quantize<float, uint16_t>(x, codes, scales, nblocks, block, f,
                                     inv_max, pow2, stream);
  return (int)cudaGetLastError();
}

int f2p_dequantize(const void* codes, int code_bytes, const float* scales,
                   void* out, int out_bf16, long long total, int block,
                   F2PConsts f, cudaStream_t stream) {
  if (total <= 0) return 0;
  if (code_bytes == 1 && out_bf16)
    launch_dequantize<uint8_t, __nv_bfloat16>(codes, scales, out, total, block, f,
                                              stream);
  else if (code_bytes == 1)
    launch_dequantize<uint8_t, float>(codes, scales, out, total, block, f, stream);
  else if (out_bf16)
    launch_dequantize<uint16_t, __nv_bfloat16>(codes, scales, out, total, block, f,
                                               stream);
  else
    launch_dequantize<uint16_t, float>(codes, scales, out, total, block, f, stream);
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

int f2p_dequant_matmul(const void* x, int x_bf16, const void* w, int code_bytes,
                       int W, const float* scales, float* part, float* y, int M,
                       int N, int K, int block, int bm, int k_chunk, int splits,
                       F2PConsts f, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (code_bytes == 1)
    launch_matmul_in(x_bf16, x, UnpackedW<uint8_t>{(const uint8_t*)w, N}, scales,
                     part, M, N, K, block, bm, k_chunk, splits, f, stream);
  else if (code_bytes == 2)
    launch_matmul_in(x_bf16, x, UnpackedW<uint16_t>{(const uint16_t*)w, N},
                     scales, part, M, N, K, block, bm, k_chunk, splits, f, stream);
  else
    launch_matmul_in(x_bf16, x, PackedW{(const uint32_t*)w, W, f.n_bits}, scales,
                     part, M, N, K, block, bm, k_chunk, splits, f, stream);
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const int grid = (int)min((mn + 255) / 256, (long long)1 << 16);
    sum_splits_kernel<<<grid, 256, 0, stream>>>(part, y, mn, splits);
  }
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
