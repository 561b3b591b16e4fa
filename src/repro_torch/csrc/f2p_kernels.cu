// Hand-written Hopper (sm_90a) kernels for the F2P serve, measurement and
// training paths.
//
// Ten kernels replace the ten Pallas TPU kernels of src/repro (the JAX
// reference):
//
//   quantize_packed_write_kernel <- repro/kernels/f2p_quant.py::_quant_packed_kernel
//                                   and the KV-cache scatter that follows it
//   dequantize_packed_kernel  <- repro/kernels/f2p_quant.py::_dequant_packed_kernel
//                                (one tensor, or a layer's K and V cache in one
//                                launch: warp tiles of 512 elements, words staged
//                                coalesced, table decode; note at the kernel)
//   quantize_kernel           <- repro/kernels/f2p_quant.py::_quant_kernel (codes mode;
//                                quantize_generic_kernel for other blocks)
//   ef_roundtrip_kernel       <- the same, in its round-trip mode: _quant_kernel,
//                                _dequant_kernel and the error-feedback glue of
//                                repro/optim/compress.py over all of a train
//                                step's compressed leaves in one launch (bound
//                                by bytes: 12 B per element, bf16 g and f32 r
//                                read and written; table-driven encode, codes
//                                and scales in registers; note at the kernel)
//   dequantize_kernel         <- repro/kernels/f2p_quant.py::_dequant_kernel
//   attention_decode_kernel   <- repro/kernels/f2p_attention.py::_fused_kernel (dense)
//                                and ::_paged_kernel (paged), split KV
//   counter_advance_kernel    <- repro/kernels/f2p_counter.py::_advance_kernel
//   counter_estimate_kernel   <- repro/kernels/f2p_counter.py::_estimate_kernel
//   dequant_matmul_mma_kernel<TIn, UnpackedW>  <- repro/kernels/f2p_matmul.py::_kernel
//   dequant_matmul_mma_kernel<TIn, PackedW>    <- repro/kernels/f2p_matmul.py::_packed_kernel
//     (M > 8 on the tensor cores, for formats whose decoded values hold at
//      most 8 significant bits and blocks of 16 rows or more;
//      dequant_matmul_kernel<UnpackedW | PackedW>, f32 SIMT, takes the other
//      formats and blocks; dequant_matmul_decode_kernel<DecU8 | DecU16 |
//      DecPacked> takes M <= 8, the decode batch)
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (repro_torch/kernels/cuda.py). Every entry takes the
// caller's stream, launches, and returns cudaGetLastError(). No entry
// allocates or synchronises.
//
// Exactness (the codec is held bitwise to the torch plain version and to
// the JAX reference): no --use_fast_math; the only rounding steps of the
// encode are written as __fmul_rn (absmax * f32(1/max)) and __fdiv_rn
// (x / scale; in B5's pow2 mode x * (1/scale), exact for a power of two),
// so no contraction or approximate divide can move a code; 2^n is built by
// bit assembly; half-up mantissa rounding goes through the exact
// fractional part u - floor(u) (f2p_encode) or one integer add and shift
// (B5's table encode, tab_encode, held to f2p_encode over all 2^32 f32
// patterns by encode_check_kernel).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

// The library builds as one translation unit (F2P_PART 0, the default) or
// as parts compiled side by side and linked into one library: 1 the
// matmul's tile route, 2 its decode route, 3 attention, 4 the rest (the
// codec, the KV write and read, the counters). A part holds its entries'
// non-template kernels; the templates are compiled where an entry
// instantiates them.
#ifndef F2P_PART
#define F2P_PART 0
#endif
#define F2P_IN(p) (F2P_PART == 0 || F2P_PART == (p))

// Format constants, as repro_torch.kernels.f2p_quant._fmt_consts gives them.
struct F2PConsts {
  int nu, h, sgn, vmax, v_sub, v_top, bias, is_signed, n_bits;
};

// A per-row int32 / int64 value read in place from a tensor at b * stride
// (stride 0: one value for every row), or ``value`` when p is null: the
// attention lengths and offsets, the KV write's start positions.
struct AttnLen {
  const void* p;
  long long stride;
  int is64;
  int value;
};

__device__ __forceinline__ long long attn_len(const AttnLen& a, int b) {
  if (!a.p) return a.value;
  const long long i = (long long)b * a.stride;
  return a.is64 ? reinterpret_cast<const long long*>(a.p)[i]
                : (long long)reinterpret_cast<const int*>(a.p)[i];
}

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

// max that returns NaN when either input is NaN (fmaxf drops it)
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A scale block's scale from its lanes' absmax, taken with fmax_nan and
// reduced over the warp: absmax * f32(1/max), rounded up to a power of two
// in pow2 mode; 1 for an all-zero block and for a block holding a NaN (the
// plain version's absmax is NaN there, and NaN > 0 is false).
__device__ __forceinline__ float block_scale(float amax, float inv_max, bool pow2) {
  for (int off = 16; off; off >>= 1)
    amax = fmax_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float scale = __fmul_rn(amax, inv_max);
  if (pow2) scale = pow2_round_up(scale > 0.0f ? scale : 1.0f);
  return amax > 0.0f ? scale : 1.0f;
}

// ---------------------------------------------------------------------------
// B5: quantize_kernel, x [rows, cols] -> codes [rows, cols] uint8 (n <= 8) or
// uint16 + scales [rows, cols / 128] (the codes mode), and ef_roundtrip_kernel,
// B5's round-trip mode: the gradient round trip with error feedback over all
// of a train step's compressed leaves in one launch (B5, then B6's decode,
// then the residual and gradient updates, the codes and scales kept in
// registers). Replaces repro/kernels/f2p_quant.py::_quant_kernel; the round
// trip also replaces ::_dequant_kernel on the train path and the eager glue
// of optim/compress.py around them (r += g, r -= q, g = q).
//
// What held the old kernel back (measured on the H100: chip_smoke phase 3 and
// tools/ef_bench.py): the arithmetic encode f2p_encode, with its runtime
// shifts, esize_of loop over a runtime h and two overflow passes, took ~160
// SASS instructions per element, so the kernel was issue bound at ~4x its
// bytes bound. The design:
//  * a table-driven encode (tab_encode): |y|'s f32 biased exponent indexes a
//    256-entry table in shared memory (f2p_quant.encode_table builds it on the
//    host from the format's constants) whose entry gives the code as off + m
//    or a saturated code, m = the 24-bit significand rounded half up to the
//    bucket's width by one add and one shift. f32 subnormals, values below
//    and above the format's range, the top clamp, inf and NaN are entries of
//    the same table. About a dozen instructions per element (~30 with the
//    divide, against ~160), for every format of <= 16 bits; held to
//    f2p_encode over all 2^32 f32 patterns on the card (encode_check_kernel,
//    chip_smoke phase 3). The codes mode now runs at ~80% of its bytes bound.
//  * pow2 scales multiply by the exact reciprocal (1/s is a power of two in
//    [2^-127, 2^126], so x * (1/s) and x / s round the same real once); f32
//    scales keep the IEEE divide.
//  * a persistent grid (as many CTAs of 8 warps as fit on the SMs); each warp
//    takes kQPass scale blocks per pass (b and b + W), every load in flight
//    before the first encode; the absmax is a NaN-propagating max.
// The round trip, per scale block: gin = r + g (error feedback) or g, the
// block scale and codes exactly as the codes mode makes them, q = decode x
// scale (the table entry's step: B6's value), r <- gin - q, g <- q rounded to
// g's dtype. A leaf table (EFLeaf rows, one async copy per step) gives each
// leaf's pointers, first global block, cols and blocks per row; a warp walks
// the global block index upward and moves its leaf cursor forward. A row's
// last block may be ragged: its columns past the row's end read as 0 and are
// not written. Bound by bytes: 12 B per element for bf16 g with error
// feedback (read g and r, write both), 4 B without; the eager composition it
// replaced moved ~38. It runs at ~84% of that bound.
// Blocks other than 128 and misaligned inputs of the codes mode take
// quantize_generic_kernel (the arithmetic encode, one element per lane).
// ---------------------------------------------------------------------------
constexpr int kQuantVals = 4;     // values a lane keeps per scale block of 128
constexpr int kQWarps = 8;        // warps per CTA of quantize_kernel / ef_roundtrip_kernel
constexpr int kQPass = 2;         // scale blocks a warp takes per pass
constexpr int kEncEntries = 256;  // encode-table entries, one per f32 biased exponent

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
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<uint32_t*>(&a),
                                            *reinterpret_cast<uint32_t*>(&b));
}

// The table-driven encode of y (already divided by its block's scale). Entry
// e = enc[|y|'s biased exponent] = {off, sat, lim, sh}: with M the 24-bit
// significand with its implicit bit set (also for exponent 0: the table
// folds it), m = (M + ((1 << sh) >> 1)) >> sh is |y| rounded half up to the
// bucket's step, and the payload is m >= lim ? sat : off + m. The sign goes
// to bit nu of signed formats (sign_mask 0x80000000, sign_shift 31 - nu).
// With VAL, *value is the code's decoded value: m * step, or sat's value
// (val[e] = {step, sat value}), signed like y: B6's value, exactly.
template <bool VAL>
__device__ __forceinline__ uint32_t tab_encode(float y, const int4* __restrict__ enc,
                                              const float2* __restrict__ val,
                                              uint32_t sign_mask, int sign_shift,
                                              float* value) {
  const uint32_t bits = __float_as_uint(y);
  const uint32_t mag = bits & 0x7FFFFFFFu;
  const uint32_t ex = mag >> 23;
  const int4 t = enc[ex];
  const uint32_t sh = (uint32_t)t.w;
  const uint32_t m = (((mag | 0x800000u) & 0xFFFFFFu) + ((1u << sh) >> 1)) >> sh;
  const bool sat = m >= (uint32_t)t.z;
  if constexpr (VAL) {
    const float2 d = val[ex];
    // m < 2^23 on this side: 2^23 + m is exact, and so is taking 2^23 away
    const float mf = __fsub_rn(__uint_as_float(0x4B000000u | m), 8388608.0f);
    const float v = sat ? d.y : __fmul_rn(mf, d.x);
    *value = __uint_as_float(__float_as_uint(v) | (bits & sign_mask));
  }
  return (sat ? (uint32_t)t.y : (uint32_t)t.x + m) | ((bits & sign_mask) >> sign_shift);
}

template <typename TIn, typename TCode, bool POW2>
__global__ void __launch_bounds__(kQWarps * 32)
quantize_kernel(const TIn* __restrict__ x, TCode* __restrict__ codes,
                float* __restrict__ scales, int nblocks, const int4* __restrict__ enc_g,
                uint32_t sign_mask, int sign_shift, float inv_max) {
  __shared__ int4 enc[kEncEntries];
  for (int i = threadIdx.x; i < kEncEntries; i += blockDim.x) enc[i] = enc_g[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  for (int b0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; b0 < nblocks;
       b0 += kQPass * nw) {
    float v[kQPass][kQuantVals];
#pragma unroll
    for (int p = 0; p < kQPass; ++p) {
      const int b = b0 + p * nw;
      if (b < nblocks) load4(x + (size_t)b * 128 + 4 * lane, v[p]);
    }
#pragma unroll
    for (int p = 0; p < kQPass; ++p) {
      const int b = b0 + p * nw;
      if (b < nblocks) {   // warp-uniform
        float amax = 0.0f;
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) amax = fmax_nan(amax, fabsf(v[p][k]));
        const float scale = block_scale(amax, inv_max, POW2);
        const float rs = POW2 ? __fdiv_rn(1.0f, scale) : 0.0f;
        if (lane == 0) scales[b] = scale;
        uint32_t c[kQuantVals];
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) {
          const float y = POW2 ? __fmul_rn(v[p][k], rs) : __fdiv_rn(v[p][k], scale);
          c[k] = tab_encode<false>(y, enc, nullptr, sign_mask, sign_shift, nullptr);
        }
        store4(codes + (size_t)b * 128 + 4 * lane, c);
      }
    }
  }
}

// One compressed leaf of the round trip, as f2p_quant.ef_plan lays it out
// (32 bytes). The row after a launch's last leaf holds only blk0 = the
// launch's block count.
struct EFLeaf {
  void* g;     // gradient [rows, cols], f32 or bf16 (kLeafBf16), contiguous
  float* r;    // f32 residual of the same shape (unused without error feedback)
  int blk0;    // global index of the leaf's first scale block
  int cols;    // last dim; a row has nbr = ceil(cols / 128) scale blocks
  int nbr;
  int flags;   // kLeafBf16 | kLeafVec (cols % 4 == 0 and 16-byte rows of 4)
};
constexpr int kLeafBf16 = 1, kLeafVec = 2;

template <bool EF>
__global__ void __launch_bounds__(kQWarps * 32)
ef_roundtrip_kernel(const EFLeaf* __restrict__ leaves, int nleaves, int nblocks,
                    const int4* __restrict__ enc_g, const float2* __restrict__ val_g,
                    uint32_t sign_mask, int sign_shift, float inv_max) {
  __shared__ int4 enc[kEncEntries];
  __shared__ float2 val[kEncEntries];
  for (int i = threadIdx.x; i < kEncEntries; i += blockDim.x) {
    enc[i] = enc_g[i];
    val[i] = val_g[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int nw = (gridDim.x * blockDim.x) >> 5;
  int b0 = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  // the last leaf whose first block is <= b0, then a cursor that only moves up
  int leaf = 0;
  for (int hi = nleaves - 1; leaf < hi;) {
    const int mid = (leaf + hi + 1) >> 1;
    if (leaves[mid].blk0 <= b0) leaf = mid; else hi = mid - 1;
  }
  int lend = leaves[leaf + 1].blk0;
  for (; b0 < nblocks; b0 += kQPass * nw) {
    float gv[kQPass][kQuantVals], rv[kQPass][kQuantVals];
    char* gp[kQPass];
    float* rp[kQPass];
    int valid[kQPass], flags[kQPass];
#pragma unroll
    for (int p = 0; p < kQPass; ++p) {
      const int b = b0 + p * nw;
      valid[p] = 0;
      flags[p] = 0;
      gp[p] = nullptr;
      rp[p] = nullptr;
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) gv[p][k] = rv[p][k] = 0.0f;
      if (b >= nblocks) continue;   // warp-uniform
      while (b >= lend) lend = leaves[++leaf + 1].blk0;
      const EFLeaf L = leaves[leaf];
      const int local = b - L.blk0;
      const int row = local / L.nbr;
      const int j = local - row * L.nbr;
      const int off = row * L.cols + j * 128;   // < 2^31: ef_plan checks each leaf
      const bool bf16 = L.flags & kLeafBf16;
      valid[p] = min(128, L.cols - j * 128);
      flags[p] = L.flags;
      gp[p] = reinterpret_cast<char*>(L.g) + (size_t)off * (bf16 ? 2 : 4);
      rp[p] = EF ? L.r + off : nullptr;
      const int e = 4 * lane;
      if (L.flags & kLeafVec) {
        if (e < valid[p]) {
          if (bf16) load4(reinterpret_cast<const __nv_bfloat16*>(gp[p]) + e, gv[p]);
          else load4(reinterpret_cast<const float*>(gp[p]) + e, gv[p]);
          if (EF) load4(rp[p] + e, rv[p]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) {
          if (e + k >= valid[p]) continue;
          gv[p][k] = bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(gp[p])[e + k])
                          : reinterpret_cast<const float*>(gp[p])[e + k];
          if (EF) rv[p][k] = rp[p][e + k];
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kQPass; ++p) {
      if (!valid[p]) continue;   // warp-uniform
      float gin[kQuantVals], q[kQuantVals], rn[kQuantVals];
      float amax = 0.0f;
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        gin[k] = EF ? __fadd_rn(rv[p][k], gv[p][k]) : gv[p][k];
        amax = fmax_nan(amax, fabsf(gin[k]));
      }
      const float scale = block_scale(amax, inv_max, false);
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        float v;
        tab_encode<true>(__fdiv_rn(gin[k], scale), enc, val, sign_mask, sign_shift, &v);
        q[k] = __fmul_rn(v, scale);
        rn[k] = __fsub_rn(gin[k], q[k]);
      }
      const int e = 4 * lane;
      const bool bf16 = flags[p] & kLeafBf16;
      if (flags[p] & kLeafVec) {
        if (e < valid[p]) {
          if (bf16) store4(reinterpret_cast<__nv_bfloat16*>(gp[p]) + e, q);
          else store4(reinterpret_cast<float*>(gp[p]) + e, q);
          if (EF) store4(rp[p] + e, rn);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) {
          if (e + k >= valid[p]) continue;
          if (bf16) store(reinterpret_cast<__nv_bfloat16*>(gp[p]) + e + k, q[k]);
          else store(reinterpret_cast<float*>(gp[p]) + e + k, q[k]);
          if (EF) rp[p][e + k] = rn[k];
        }
      }
    }
  }
}

// The codes mode for any block and alignment: one warp per scale block, lane
// l takes elements l, l + 32, ..., the arithmetic encode. A block of at most
// 128 stays in registers between the absmax and the encode; a wider one is
// read twice (the second time from L1/L2).
template <typename TIn, typename TCode>
__global__ void quantize_generic_kernel(const TIn* __restrict__ x,
                                        TCode* __restrict__ codes,
                                        float* __restrict__ scales, long long nblocks,
                                        int block, F2PConsts f, float inv_max, int pow2) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const bool in_regs = block <= 32 * kQuantVals;
  for (long long wb = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       wb < nblocks; wb += nwarps) {
    const TIn* xb = x + wb * block;
    TCode* cb = codes + wb * block;
    float v[kQuantVals];
    float amax = 0.0f;
    if (in_regs) {
#pragma unroll
      for (int k = 0; k < kQuantVals; ++k) {
        const int i = lane + 32 * k;
        v[k] = i < block ? to_f32(xb[i]) : 0.0f;
        amax = fmax_nan(amax, fabsf(v[k]));
      }
    } else {
      for (int i = lane; i < block; i += 32) amax = fmax_nan(amax, fabsf(to_f32(xb[i])));
    }
    const float scale = block_scale(amax, inv_max, pow2);
    if (lane == 0) scales[wb] = scale;
    if (in_regs) {
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

// The exhaustive check of the table encode (chip_smoke phase 3): for every
// 32-bit pattern y in [start, start + count), with s == 0 the table's code
// and value against f2p_encode and f2p_decode of it; with s a power of two,
// y * (1/s) against __fdiv_rn(y, s). Mismatches are counted in *bad and the
// smallest mismatching pattern is kept in *first.
#if F2P_IN(4)
__global__ void encode_check_kernel(unsigned start, long long count,
                                    const int4* __restrict__ enc_g,
                                    const float2* __restrict__ val_g, F2PConsts f,
                                    float s, unsigned long long* bad, unsigned* first) {
  __shared__ int4 enc[kEncEntries];
  __shared__ float2 val[kEncEntries];
  for (int i = threadIdx.x; i < kEncEntries; i += blockDim.x) {
    enc[i] = enc_g[i];
    val[i] = val_g[i];
  }
  __syncthreads();
  const uint32_t sign_mask = f.is_signed ? 0x80000000u : 0u;
  const int sign_shift = 31 - f.nu;
  const float rs = s != 0.0f ? __fdiv_rn(1.0f, s) : 0.0f;
  unsigned n_bad = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    const unsigned pat = start + (unsigned)i;
    const float y = __uint_as_float(pat);
    bool ok;
    if (s == 0.0f) {
      float v;
      const uint32_t c = tab_encode<true>(y, enc, val, sign_mask, sign_shift, &v);
      const uint32_t want = f2p_encode(y, f);
      ok = c == want && __float_as_uint(v) == __float_as_uint(f2p_decode(want, f));
    } else {
      ok = __float_as_uint(__fmul_rn(y, rs)) == __float_as_uint(__fdiv_rn(y, s));
    }
    if (!ok) {
      ++n_bad;
      atomicMin(first, pat);
    }
  }
  if (n_bad) atomicAdd(bad, (unsigned long long)n_bad);
}
#endif

// ---------------------------------------------------------------------------
// B3, quantize_packed_write_kernel: rows of one or two inputs (a layer's K
// and V) -> packed F2P words + block scales, each row stored at its cache
// position. Replaces repro/kernels/f2p_quant.py::_quant_packed_kernel
// together with the scatter that follows it in repro/models/attention.py
// (_paged_cache_write, _cache_write: quantize, then .at[page, off].set).
//
// What bounds it: at the decode shape (K and V of 8 slots x 8 kv heads x
// head_dim 128, bf16) the call moves ~50 KB, 15 ns at 3.35 TB/s, far below
// one launch. So a layer's KV write is bound by launch latency and the
// host, not by bytes, and the design spends exactly one launch on it: K and
// V, the page and offset arithmetic (position p = pos[b] + s, page =
// pages[b, min(p / T, maxp - 1)], offset p % T; with no table, page b and
// offset p), the encode and the store into the cache, with no temporaries.
// Contiguous output rows (f2p_quantize_packed) are the same call with
// T = 1, pos 0 and no table.
//
// Work unit: one warp per (input, row, chunk), kKVWarps warps per CTA, so a
// decode call's 2 x 64 rows fill 32 CTAs and a [8192, 128] prefill 2048. A
// chunk is the fewest whole scale blocks whose packed bits end on a word
// boundary (one block whenever block * n_bits % 32 == 0, as at block 128),
// so no two warps write one word. At block 128 with 4-element-aligned rows
// (vec), lane l loads elements 4l..4l+3 in one 16-byte (f32) or 8-byte
// (bf16) load and keeps them in registers through the shuffle absmax and
// the encode; at 8 bits its 4 codes are its output word, stored straight
// from registers (direct). Other widths stage the warp's codes in its own
// shared-memory slice and assemble each word in one lane; other blocks and
// unaligned or strided rows take one element per lane. A row whose
// destination lies outside the cache is skipped. Through a page table
// several rows may land on one position (retired slots all point at the
// dump page): only the last of them in (b, s) order writes, as in a
// sequential scatter, so what the page holds never depends on the order
// in which warps run (an MoE routes the idle slots that read it, and
// their expert picks take capacity from the live ones).
// ---------------------------------------------------------------------------
constexpr int kKVWarps = 4;

// One input as the C entry takes it: x [B, S, Kh, cols] at strides (in
// elements), its destination rows of W words and cols / block scales.
struct KVSideIn {
  const void* x;
  long long sb, ss, sh, sd;
  uint32_t* words;
  float* scales;
  int W;
  F2PConsts f;
  float inv_max;
};

struct KVSide {
  KVSideIn in;
  int chunk, nchunk;   // scale blocks per chunk, chunks per row
  int vec, direct;     // direct: 8-bit codes stored from registers
};

struct KVWriteArgs {
  KVSide side[2];
  int tasks0, tasks;         // side 0's warp tasks, all warp tasks
  const int* pages;          // [B, maxp] int32, or null: page b, offset p
  AttnLen pos;               // start positions
  int B, S, Kh, block, nblk, T, P, maxp, pow2, stage;
};

template <typename TIn>
__global__ void __launch_bounds__(kKVWarps * 32)
quantize_packed_write_kernel(const __grid_constant__ KVWriteArgs a) {
  extern __shared__ uint32_t kv_stage[];
  const int lane = threadIdx.x & 31;
  uint32_t* stage = kv_stage + (size_t)(threadIdx.x >> 5) * a.stage;
  // 32-bit index math (the entry keeps tasks and positions below 2^31):
  // a 64-bit divide costs several times a 32-bit one on this chain
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < a.tasks;
       t += nwarps) {
    const int si = t >= a.tasks0;
    const KVSide& io = a.side[si];
    const int u = t - (si ? a.tasks0 : 0);
    const int row = u / io.nchunk;
    const int c = u - row * io.nchunk;
    const int bs = row / a.Kh;
    const int h = row - bs * a.Kh;
    const int b = bs / a.S;
    const int s = bs - b * a.S;
    const TIn* xr = reinterpret_cast<const TIn*>(io.in.x) + b * io.in.sb +
                    s * io.in.ss + h * io.in.sh;
    const long long sd = io.in.sd;
    const int b0 = c * io.chunk, b1 = min(b0 + io.chunk, a.nblk);
    // a vec row's values are loaded first, so that their latency overlaps
    // the dependent position -> page-id loads (vec: block 128, one block
    // per chunk)
    float v[kQuantVals];
    if (io.vec) load4(xr + (long long)b0 * a.block + 4 * lane, v);
    const int p = (int)attn_len(a.pos, b) + s;
    int page = b, off = p;
    if (a.pages) {
      const int col = min(p / a.T, a.maxp - 1);
      page = col < 0 ? -1 : a.pages[(long long)b * a.maxp + col];
      off = p - (p / a.T) * a.T;
    }
    if (off < 0 || off >= a.T || page < 0 || page >= a.P) continue;  // warp-uniform
    if (a.pages) {
      // a later row (b, s) with the same destination writes it instead
      bool later = false;
      for (int j = bs + 1 + lane; j < a.B * a.S; j += 32) {
        const int b2 = j / a.S, s2 = j - b2 * a.S;
        const int p2 = (int)attn_len(a.pos, b2) + s2;
        const int col2 = min(p2 / a.T, a.maxp - 1);
        if (col2 < 0) continue;
        later |= a.pages[(long long)b2 * a.maxp + col2] == page &&
                 p2 - (p2 / a.T) * a.T == off;
      }
      if (__any_sync(0xffffffffu, later)) continue;  // warp-uniform
    }
    const long long dst = ((long long)page * a.T + off) * a.Kh + h;
    const int nb = io.in.f.n_bits;
    const long long w0 = (long long)b0 * a.block * nb / 32;
    uint32_t* wr = io.in.words + dst * io.in.W + w0;
    float* sr = io.in.scales + dst * a.nblk;
    const bool in_regs = io.vec || a.block <= 32 * kQuantVals;
    for (int bi = b0; bi < b1; ++bi) {
      const long long e0 = (long long)bi * a.block;
      uint32_t* cs = stage + (bi - b0) * a.block;
      float amax = 0.0f;
      if (in_regs) {
        if (!io.vec) {   // (a vec row's values were loaded above)
#pragma unroll
          for (int k = 0; k < kQuantVals; ++k) {
            const int i = lane + 32 * k;
            v[k] = i < a.block ? to_f32(xr[(e0 + i) * sd]) : 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) amax = fmax_nan(amax, fabsf(v[k]));
      } else {
        for (int i = lane; i < a.block; i += 32)
          amax = fmax_nan(amax, fabsf(to_f32(xr[(e0 + i) * sd])));
      }
      const float scale = block_scale(amax, io.in.inv_max, a.pow2);
      if (lane == 0) sr[bi] = scale;
      if (io.vec) {
        uint32_t q[kQuantVals];
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) q[k] = f2p_encode(__fdiv_rn(v[k], scale), io.in.f);
        if (io.direct) {
          wr[lane] = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
        } else {
#pragma unroll
          for (int k = 0; k < kQuantVals; ++k) cs[4 * lane + k] = q[k];
        }
      } else if (in_regs) {
#pragma unroll
        for (int k = 0; k < kQuantVals; ++k) {
          const int i = lane + 32 * k;
          if (i < a.block) cs[i] = f2p_encode(__fdiv_rn(v[k], scale), io.in.f);
        }
      } else {
        for (int i = lane; i < a.block; i += 32)
          cs[i] = f2p_encode(__fdiv_rn(to_f32(xr[(e0 + i) * sd]), scale), io.in.f);
      }
    }
    if (io.direct) continue;
    // assemble the chunk's words from the staged codes: word w holds the
    // fields that overlap bits [32w, 32w + 32) of the chunk
    __syncwarp();
    const int n = (b1 - b0) * a.block;
    const long long wend = min(((long long)b1 * a.block * nb + 31) / 32, (long long)io.in.W);
    for (int w = lane; w < (int)(wend - w0); w += 32) {
      const int bit0 = w * 32;
      const int i0 = bit0 / nb, i1 = min((bit0 + 31) / nb, n - 1);
      uint32_t word = 0;
      for (int i = i0; i <= i1; ++i) {
        const int o = i * nb - bit0;
        word |= o >= 0 ? (stage[i] << o) : (stage[i] >> (-o));
      }
      wr[w] = word;
    }
    __syncwarp();
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
// counter_advance: the stochastic advance of F2P grid counters (B9)
//
// One thread per cell of the flattened state. Each of `sweeps` sweeps
// crosses the run of p = 1 states in one step, then draws the geometric
// sojourn ceil(log u / log(1-p)) of the current state and advances if the
// remaining budget covers it (repro_torch.kernels.f2p_counter._sweep). The
// uniforms are not streamed in: u = hash(seed, sweep0 + t, lane) is
// computed in registers, the same counter-based stream hash_uniforms builds
// for the plain version. lane = lane_base + i is the cell's index in the
// whole state: a rank holding a row shard of a sketch passes its first
// cell's global index, so it draws the unsharded sketch's stream. Bound by bytes (state + budget in, state +
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

#if F2P_IN(4)
__global__ void counter_advance_kernel(const int* __restrict__ state_in,
                                       const float* __restrict__ budget,
                                       int* __restrict__ state_out,
                                       float* __restrict__ left,
                                       const float* __restrict__ p_lut,
                                       const float* __restrict__ run_lut,
                                       const float* __restrict__ logq_lut,
                                       long long n, int kmax, uint32_t seed,
                                       uint32_t sweep0, int sweeps,
                                       long long lane_base) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t lane = (uint32_t)(lane_base + i);
  int s = state_in[i];
  float rem = budget[i];
  for (int t = 0; t < sweeps && rem > 0.f; ++t) {
    const float run = fminf(rem, __ldg(run_lut + s));
    s += (int)run;  // truncation, as torch's f32 -> int32
    rem = __fsub_rn(rem, run);
    const float pk = __ldg(p_lut + s);
    const float u = hash_uniform(seed, sweep0 + (uint32_t)t, lane);
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
#endif

// ---------------------------------------------------------------------------
// counter_estimate: L[state], one thread per cell (B10). Bound by bytes
// (4 B of state in, 4 B of estimate out); the grid stays in L2.
// ---------------------------------------------------------------------------
#if F2P_IN(4)
__global__ void counter_estimate_kernel(const int* __restrict__ state,
                                        const float* __restrict__ grid,
                                        float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __ldg(grid + state[i]);
}
#endif

// ---------------------------------------------------------------------------
// dequant_matmul: y[M, N] f32 = x[M, K] (f32 or bf16) @ W, W[k, n] =
// decode(code[k, n]) * scales[k / block, n] (B8 from uint8 / uint16 codes,
// B7 from each K-row's bit-packed words). This SIMT kernel is f32 only:
// every W element is the correctly rounded f32 product decode * scale, as
// the plain version's, and the sum is f32 FMAs (no TF32, no bf16 tensor
// cores). It serves M > 8 for the formats and blocks the tensor-core kernel
// below does not take (decoded values of more than 8 significant bits,
// f2p_sr_2_12s and f2p_sr_2_16s; n_bits above 10; blocks that are not a
// multiple of 16): a second kernel chosen up front on the host
// (f2p_matmul.tile_kernel), not a fallback.
//
// At a prefill batch (M = 2048) it is bound by its f32 operations (67
// TFLOP/s outside the tensor cores). A simple SIMT design: one CTA of 256
// threads per (BM x 128) output tile, BM = 8 * TM covering M (so a decode
// batch does not pad to 128 rows); per K step of 32 it stages the x tile
// (as f32, k-major) and the decoded, scaled W tile in shared memory, and
// warp w / lane l accumulate rows w + 8i (i < TM) x columns l + 32j (j < 4)
// in registers. Formats of at most 10 bits decode through a table in
// shared memory built with f2p_decode (the same values bit for bit), wider
// ones call f2p_decode per element. When the output tiles alone leave the
// card idle, K is split across `splits` CTAs, each writing its partial
// tile to part[split]; sum_splits_kernel then adds the partials in split
// order, so the result does not depend on scheduling. A decode batch (M
// <= 8) goes to dequant_matmul_decode_kernel below.
// ---------------------------------------------------------------------------
constexpr int kMmBN = 128, kMmBK = 32, kMmThreads = 256, kMmLut = 1024;

// A weight source. code(k, n): one code (the SIMT kernel). For the
// tensor-core kernel's staging, per tile of kMmaCols columns: the byte span
// of tile bx in K row 0 (`span`, with the bytes of it that lie in the row;
// row k's is stride() bytes further), of pieces() 16-byte pieces, staged
// at pitch() bytes a row (an odd number of 16-byte units, so that the 8
// rows a quarter warp decodes lie on distinct banks); and the 8 codes of
// the tile's 8-column chunk nc from a staged row (`unit`).
constexpr int kMmaCols = 128;

template <typename TCode>
struct UnpackedW {
  static constexpr int kElem = sizeof(TCode);
  const TCode* __restrict__ codes;
  int N;
  __device__ __forceinline__ uint32_t code(int k, int n) const {
    return (uint32_t)codes[(size_t)k * N + n];
  }
  __host__ __device__ long long stride() const { return (long long)N * kElem; }
  __host__ __device__ int pieces() const { return kMmaCols * kElem / 16; }
  __host__ __device__ int pitch() const { return 16 * (pieces() + 1); }   // 9 | 17 units
  __host__ __device__ bool aligned() const {
    return (uintptr_t)codes % 16 == 0 && stride() % 16 == 0;
  }
  __device__ __forceinline__ const uint8_t* span(int bx, int& valid) const {
    valid = min(kMmaCols, N - bx * kMmaCols) * kElem;
    return reinterpret_cast<const uint8_t*>(codes + bx * kMmaCols);
  }
  __device__ __forceinline__ void unit(const uint8_t* row, int nc, uint32_t* c) const {
    if constexpr (kElem == 1) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + 8 * nc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = (v.x >> (8 * j)) & 0xFFu;
        c[4 + j] = (v.y >> (8 * j)) & 0xFFu;
      }
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * nc);
      const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[2 * j] = h[j] & 0xFFFFu;
        c[2 * j + 1] = h[j] >> 16;
      }
    }
  }
};

struct PackedW {
  static constexpr int kElem = 4;
  const uint32_t* __restrict__ words;
  int W, nb;
  __device__ __forceinline__ uint32_t code(int k, int n) const {
    return get_field(words + (size_t)k * W, n, nb);
  }
  __host__ __device__ long long stride() const { return 4LL * W; }
  // a tile's kMmaCols fields fill 4 nb whole words
  __host__ __device__ int pieces() const { return nb; }
  // at least 16 bytes past the span (a unit's word window may read past
  // it), an odd number of 16-byte units
  __host__ __device__ int pitch() const { return 16 * (nb + 1 + (nb & 1)); }
  __host__ __device__ bool aligned() const {
    return (uintptr_t)words % 16 == 0 && W % 4 == 0;
  }
  __device__ __forceinline__ const uint8_t* span(int bx, int& valid) const {
    const int w0 = bx * 4 * nb;
    valid = 4 * min(4 * nb, W - w0);
    return reinterpret_cast<const uint8_t*>(words + w0);
  }
  // fields 8 nc .. 8 nc + 7: DecPacked's window cut, at bit 8 nb nc
  __device__ __forceinline__ void unit(const uint8_t* row, int nc, uint32_t* c) const;
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
#if F2P_IN(1)
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
#endif

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
// dequant_matmul, decode route (M <= 8): the same function as
// dequant_matmul_kernel, y[M, N] f32 = f32(x) @ (decode(code) * scale), for
// a decode batch, where the kernel has to stream the weight at the card's
// memory rate and do M f32 FMAs per weight on the way.
//
// Layout of the work. Lane l of every warp owns a strip of 8 consecutive
// columns n0 = 256 * blockIdx.x + 8 l and keeps 8 x 8 f32 sums in
// registers, one row of them per row of x (rows >= M read x as zero).
// The CTA's 8 warps share those 256 columns and take consecutive ranges of
// the CTA's K chunk (blockIdx.y); at the end they are added in a fixed
// tree order through shared memory. With K split over several CTAs, each
// writes its partial to part[split], and the last CTA of a column group
// to finish (an atomic count per group, reset by that CTA) adds the
// partials in split order into y: the result does not depend on
// scheduling, and no second kernel is launched. The grid (column groups x
// K splits) is planned by repro_torch.kernels.f2p_matmul.decode_plan.
//
// The stream. Each warp keeps a ring of dec_stages() units of 4 K rows (its
// 256 columns of each row: 256 B of uint8 codes, 512 B of uint16 codes,
// 32 n_bits bytes of packed words) in shared memory, filled with 16-byte
// cp.async copies: all but one unit are in flight while one is consumed
// (a ring of about 5 KB per warp). Where a row's span is not 16-byte
// aligned (a row stride that is not a multiple of 16 bytes) the warp copies
// its units with plain loads instead. Packed fields: the lane's 8 fields
// start at bit 8 * n_bits * l of the span, a multiple of 8, so the lane
// reads the 3 (n_bits <= 8) or 5 words that cover them, funnel-shifts the
// window to its first field and cuts the fields out (any n_bits <= 16).
//
// Decode and scale. Formats of at most 8 bits decode through a table in
// shared memory replicated once per bank (entry c of lane l at c * 32 + l,
// so random codes never collide on a bank), wider ones with f2p_decode.
// Every W element is the correctly rounded f32 product decode * scale (as
// the plain version's W); a unit lies in one scale block (block % 4 == 0),
// and the next block's scales are loaded while the unit before it is
// consumed, with no divide. x[:, chunk] is staged once per CTA as f32,
// k-major, and read as broadcast 16-byte loads.
// ---------------------------------------------------------------------------
constexpr int kDecStrip = 8, kDecCols = 32 * kDecStrip, kDecUnit = 4, kDecWarps = 8;
constexpr int kDecRows = 8;           // rows of x: the route's M <= 8
constexpr int kDecRingBytes = 5120;   // about one warp's ring of units
constexpr int kDecMaxStages = 8;
static_assert(32 * kDecWarps == kDecCols, "the last CTA adds one column per thread");

// slots of a warp's ring for K rows of row_bytes bytes each
__host__ __device__ constexpr int dec_stages(int row_bytes) {
  const int s = kDecRingBytes / (kDecUnit * row_bytes);
  return s < 2 ? 2 : s > kDecMaxStages ? kDecMaxStages : s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait until at most n (1 to kDecMaxStages - 1) groups of copies are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<kDecMaxStages - 1>(); break;
  }
}

extern __shared__ float4 dec_smem4[];   // the decode kernel's shared memory; its table first

// A weight source: the byte span of column group cg in K row 0 (`span0`,
// with the bytes of it that lie in the row; row k's is `stride` bytes
// further per row), of `pieces()` 16-byte pieces, and the 8 codes of lane l
// from that span staged in shared memory (`fields`), or for a table decode
// their byte offsets in the bank-replicated table, c * 128 + 4 l
// (`lut_offsets`). kTable: 1 always the table (byte codes), 0 never
// (uint16 codes hold more than 8 bits), -1 up to 8 bits (packed words).
struct DecU8 {
  static constexpr int kTable = 1;
  static constexpr int kPieces = 16, kElem = 1;
  const uint8_t* __restrict__ p;
  int N;
  __host__ __device__ long long stride() const { return N; }
  __host__ __device__ int pieces() const { return kPieces; }
  __device__ __forceinline__ const uint8_t* span0(int cg, int& valid) const {
    valid = min(16 * kPieces, N - cg * kDecCols);
    return p + cg * kDecCols;
  }
  __device__ __forceinline__ void lut_offsets(const uint8_t* row, uint32_t* o, int lane) const {
    const uint2 v = *reinterpret_cast<const uint2*>(row + 8 * lane);
    const uint32_t l4 = 4u * lane;
    o[0] = ((v.x << 7) & 0x7F80u) | l4;
    o[1] = ((v.x >> 1) & 0x7F80u) | l4;
    o[2] = ((v.x >> 9) & 0x7F80u) | l4;
    o[3] = ((v.x >> 17) & 0x7F80u) | l4;
    o[4] = ((v.y << 7) & 0x7F80u) | l4;
    o[5] = ((v.y >> 1) & 0x7F80u) | l4;
    o[6] = ((v.y >> 9) & 0x7F80u) | l4;
    o[7] = ((v.y >> 17) & 0x7F80u) | l4;
  }
};

struct DecU16 {
  static constexpr int kTable = 0;
  static constexpr int kElem = 2;
  const uint16_t* __restrict__ p;
  int N;
  __host__ __device__ long long stride() const { return 2LL * N; }
  __host__ __device__ int pieces() const { return 32; }
  __device__ __forceinline__ const uint8_t* span0(int cg, int& valid) const {
    valid = 2 * min(kDecCols, N - cg * kDecCols);
    return reinterpret_cast<const uint8_t*>(p + cg * kDecCols);
  }
  __device__ __forceinline__ void fields(const uint8_t* row, uint32_t* c, int lane) const {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * lane);
    const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[2 * j] = h[j] & 0xFFFFu;
      c[2 * j + 1] = h[j] >> 16;
    }
  }
};

// bit-packed words, any n_bits <= 16
struct DecPacked {
  static constexpr int kTable = -1;
  static constexpr int kElem = 4;
  const uint32_t* __restrict__ words;
  int W, nb;
  __host__ __device__ long long stride() const { return 4LL * W; }
  __host__ __device__ int pieces() const { return 2 * nb; }
  __device__ __forceinline__ const uint8_t* span0(int cg, int& valid) const {
    const int w0 = cg * 8 * nb;
    valid = 4 * min(8 * nb, W - w0);
    return reinterpret_cast<const uint8_t*>(words + w0);
  }
  // n_bits <= 8: the 8 fields fill at most 64 bits of the window, 4 in
  // each word; one funnel shift moves field j of a word to bit 7 (c * 128)
  __device__ __forceinline__ void lut_offsets(const uint8_t* row, uint32_t* o, int lane) const {
    const int bit = 8 * nb * lane, s = bit & 31;   // s is 0, 8, 16 or 24
    const uint32_t* q = reinterpret_cast<const uint32_t*>(row) + (bit >> 5);
    const uint32_t a = __funnelshift_r(q[0], q[1], s);
    const uint32_t h = __funnelshift_rc(a, __funnelshift_r(q[1], q[2], s), 4 * nb);
    const uint32_t m7 = ((1u << nb) - 1u) << 7, l4 = 4u * lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = (__funnelshift_r(a << 7, a >> 25, j * nb) & m7) | l4;
      o[4 + j] = (__funnelshift_r(h << 7, h >> 25, j * nb) & m7) | l4;
    }
  }
  __device__ __forceinline__ void fields(const uint8_t* row, uint32_t* c, int lane) const {
    const int bit = 8 * nb * lane, s = bit & 31;
    const uint32_t* q = reinterpret_cast<const uint32_t*>(row) + (bit >> 5);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(q[i], q[i + 1], s);
    // fields 0-3 in the low 64 bits of the window, 4-7 from bit 4 nb on
    const uint64_t lo = ((uint64_t)v[1] << 32) | v[0];
    const uint64_t hi = ((uint64_t)v[3] << 32) | v[2];
    const uint64_t mid = nb == 16 ? hi : (lo >> (4 * nb)) | (hi << (64 - 4 * nb));
    const uint32_t mask = (1u << nb) - 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = (uint32_t)(lo >> (j * nb)) & mask;
      c[4 + j] = (uint32_t)(mid >> (j * nb)) & mask;
    }
  }
};

__device__ __forceinline__ float x_at(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                : reinterpret_cast<const float*>(x)[i];
}

__device__ __forceinline__ void load_scales(float* s, const float* __restrict__ row,
                                            int n0, int N, int vec) {
  if (vec && n0 < N) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + n0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + n0) + 1);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kDecStrip; ++j) s[j] = n0 + j < N ? __ldg(row + n0 + j) : 0.0f;
  }
}

// One warp copies the spans of the unit's kDecUnit K rows (the first at
// row0, the next `stride` bytes apart; `valid` bytes of each lie in its
// row) into a ring slot of kDecUnit rows of 16 * pieces bytes (pieces <=
// 32): 16-byte cp.async copies (the bytes past the row's end read as
// zero), or plain element copies where the spans are not 16-byte aligned.
// Lane l takes pieces l, l + 32, ..., piece i in row i / pieces, found as
// (i * inv) >> 16 with inv = ceil(2^16 / pieces) (exact for i < 2^9).
template <typename Src>
__device__ __forceinline__ void dec_fill(uint8_t* slot, const uint8_t* row0, long long stride,
                                         int valid, int lane, int pieces, int inv, int async) {
#pragma unroll
  for (int t = 0; t < kDecUnit; ++t) {
    const int i = lane + 32 * t;
    if (i >= kDecUnit * pieces) break;
    const int r = (i * inv) >> 16, off = (i - r * pieces) << 4;
    const uint8_t* src = row0 + r * stride + off;
    uint8_t* dst = slot + r * (pieces << 4) + off;
    const int n = min(max(valid - off, 0), 16);
    if (async) {
      cp_async16(dst, n > 0 ? src : row0, n);
    } else {
#pragma unroll
      for (int e = 0; e < 16; e += Src::kElem) {
        if (Src::kElem == 1) dst[e] = e < n ? src[e] : 0;
        if (Src::kElem == 2)
          *reinterpret_cast<uint16_t*>(dst + e) =
              e < n ? *reinterpret_cast<const uint16_t*>(src + e) : 0;
        if (Src::kElem == 4)
          *reinterpret_cast<uint32_t*>(dst + e) =
              e < n ? *reinterpret_cast<const uint32_t*>(src + e) : 0u;
      }
    }
  }
}

// One unit: kDecUnit staged rows of row_bytes bytes of codes into the sums.
template <typename Src>
__device__ __forceinline__ void dec_unit(const Src& w, const uint8_t* slot, int row_bytes,
                                         const float* sc, const float* xr, int lane,
                                         int lut_bits, const F2PConsts& f,
                                         float (&acc)[kDecRows][kDecStrip]) {
#pragma unroll
  for (int r = 0; r < kDecUnit; ++r) {
    const uint8_t* row = slot + r * row_bytes;
    float wv[kDecStrip];
    const bool table = Src::kTable == 1 || (Src::kTable == -1 && lut_bits);
    if constexpr (Src::kTable != 1) {
      if (!table) {
        uint32_t c[kDecStrip];
        w.fields(row, c, lane);
#pragma unroll
        for (int j = 0; j < kDecStrip; ++j) wv[j] = __fmul_rn(f2p_decode(c[j], f), sc[j]);
      }
    }
    if constexpr (Src::kTable != 0) {
      if (table) {
        uint32_t o[kDecStrip];
        w.lut_offsets(row, o, lane);
#pragma unroll
        for (int j = 0; j < kDecStrip; ++j)
          wv[j] = __fmul_rn(*reinterpret_cast<const float*>(
                                reinterpret_cast<const uint8_t*>(dec_smem4) + o[j]), sc[j]);
      }
    }
    const float4 x0 = reinterpret_cast<const float4*>(xr + r * kDecRows)[0];
    const float4 x1 = reinterpret_cast<const float4*>(xr + r * kDecRows)[1];
    const float xm[kDecRows] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int m = 0; m < kDecRows; ++m)
#pragma unroll
      for (int j = 0; j < kDecStrip; ++j) acc[m][j] = fmaf(xm[m], wv[j], acc[m][j]);
  }
}

template <typename Src>
__global__ void __launch_bounds__(32 * kDecWarps, 2)
dequant_matmul_decode_kernel(const void* __restrict__ x, int x_bf16, Src w,
                             const float* __restrict__ scales, float* __restrict__ part,
                             float* __restrict__ y, int* __restrict__ counts, int M,
                             int N, int K, int lb, int k_chunk, int splits, int lut_bits,
                             int vec, int async, F2PConsts f) {
  const int pieces = w.pieces(), row_bytes = 16 * pieces, inv = (0xFFFF + pieces) / pieces;
  const int S = dec_stages(row_bytes);
  const int slot = kDecUnit * row_bytes + 16;   // +16: a lane's word window may run past
  float* smem = reinterpret_cast<float*>(dec_smem4);
  float* xs = smem + (lut_bits ? 32 << lut_bits : 0);   // [chunk rows][8], after the table
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint8_t* ring = reinterpret_cast<uint8_t*>(xs + (size_t)k_chunk * kDecRows) +
                  (size_t)warp * S * slot;
  const int cg = blockIdx.x, n0 = cg * kDecCols + lane * kDecStrip;
  const int kb = blockIdx.y * k_chunk, ke = min(K, kb + k_chunk);
  const int per = ((ke - kb) / kDecUnit + kDecWarps - 1) / kDecWarps * kDecUnit;
  const int wk0 = min(ke, kb + warp * per), wk1 = min(ke, wk0 + per);
  const int nunits = (wk1 - wk0) / kDecUnit;
  const long long stride = w.stride();
  int valid;
  const uint8_t* span0 = w.span0(cg, valid);

  // the first S - 1 units go in flight before the table and x are staged
  for (int i = 0; i < S - 1; ++i) {
    if (i < nunits)
      dec_fill<Src>(ring + i * slot, span0 + (wk0 + i * kDecUnit) * stride, stride, valid,
                    lane, pieces, inv, async);
    cp_async_commit();
  }
  float sc[kDecStrip], sn[kDecStrip];
  if (nunits > 0) load_scales(sc, scales + (size_t)(wk0 >> lb) * N, n0, N, vec);
  if (lut_bits) {
    const uint32_t cmask = (1u << f.n_bits) - 1u;
    for (int c = threadIdx.x; c < (1 << lut_bits); c += blockDim.x) {
      const float d = f2p_decode((uint32_t)c & cmask, f);
#pragma unroll 8
      for (int j = 0; j < 32; ++j) smem[c * 32 + ((j + lane) & 31)] = d;
    }
  }
  for (int kk = threadIdx.x; kk < ke - kb; kk += blockDim.x) {
    float v[kDecRows];
#pragma unroll
    for (int m = 0; m < kDecRows; ++m)
      v[m] = m < M ? x_at(x, x_bf16, (size_t)m * K + kb + kk) : 0.0f;
    reinterpret_cast<float4*>(xs + kk * kDecRows)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(xs + kk * kDecRows)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __syncthreads();

  float acc[kDecRows][kDecStrip];
#pragma unroll
  for (int m = 0; m < kDecRows; ++m)
#pragma unroll
    for (int j = 0; j < kDecStrip; ++j) acc[m][j] = 0.0f;
  for (int u = 0, use = 0; u < nunits; ++u, use = use + 1 == S ? 0 : use + 1) {
    // refill the slot consumed one unit ago, then wait for unit u
    if (u + S - 1 < nunits)
      dec_fill<Src>(ring + (use ? use - 1 : S - 1) * slot,
                    span0 + (wk0 + (u + S - 1) * kDecUnit) * stride, stride, valid, lane,
                    pieces, inv, async);
    cp_async_commit();
    cp_async_wait_n(S - 1);
    __syncwarp();
    const int k0 = wk0 + u * kDecUnit, kn = k0 + kDecUnit;
    const bool next_block = u + 1 < nunits && (kn >> lb) != (k0 >> lb);
    if (next_block) load_scales(sn, scales + (size_t)(kn >> lb) * N, n0, N, vec);
    dec_unit<Src>(w, ring + use * slot, row_bytes, sc, xs + (k0 - kb) * kDecRows, lane,
                  lut_bits, f, acc);
    if (next_block) {
#pragma unroll
      for (int j = 0; j < kDecStrip; ++j) sc[j] = sn[j];
    }
    __syncwarp();   // every lane is done with the slot before it is refilled
  }

  // warps w and w + half add in a fixed tree: warp 0 ends with the CTA's sum
  float* red = smem;   // [half][8 * 8][32], after every warp is done
  for (int half = kDecWarps >> 1; half; half >>= 1) {
    __syncthreads();
    if (warp >= half && warp < 2 * half) {
      float* dst = red + (size_t)(warp - half) * kDecRows * kDecStrip * 32 + lane;
#pragma unroll
      for (int m = 0; m < kDecRows; ++m)
#pragma unroll
        for (int j = 0; j < kDecStrip; ++j) dst[(m * kDecStrip + j) * 32] = acc[m][j];
    }
    __syncthreads();
    if (warp < half) {
      const float* src = red + (size_t)warp * kDecRows * kDecStrip * 32 + lane;
#pragma unroll
      for (int m = 0; m < kDecRows; ++m)
#pragma unroll
        for (int j = 0; j < kDecStrip; ++j) acc[m][j] += src[(m * kDecStrip + j) * 32];
    }
  }
  const bool live = n0 < N;
  if (warp == 0 && live) {
    float* out = (splits > 1 ? part + (size_t)blockIdx.y * M * N : y) + n0;
#pragma unroll
    for (int m = 0; m < kDecRows; ++m) {
      if (m >= M) break;
      float* o = out + (size_t)m * N;
      if (vec) {
        reinterpret_cast<float4*>(o)[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      } else {
#pragma unroll
        for (int j = 0; j < kDecStrip; ++j)
          if (n0 + j < N) o[j] = acc[m][j];
      }
    }
  }
  if (splits <= 1) return;
  // the last CTA of this column group to finish adds the partials, in
  // split order, into y
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counts + cg, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) counts[cg] = 0;   // ready for the next launch on this stream
  // thread t takes column t of the group and its M rows: the loads of
  // several splits are in flight at once, each sum runs in split order
  const int n = cg * kDecCols + threadIdx.x;
  if (n >= N) return;
  float t[kDecRows];
#pragma unroll
  for (int m = 0; m < kDecRows; ++m) t[m] = m < M ? __ldcg(part + (size_t)m * N + n) : 0.0f;
#pragma unroll 8
  for (int p = 1; p < splits; ++p) {
    const float* pp = part + (size_t)p * M * N + n;
#pragma unroll
    for (int m = 0; m < kDecRows; ++m)
      if (m < M) t[m] += __ldcg(pp + (size_t)m * N);
  }
#pragma unroll
  for (int m = 0; m < kDecRows; ++m)
    if (m < M) y[(size_t)m * N + n] = t[m];
}

// shared memory of one decode CTA: the table, the x chunk and the warps'
// rings; after the main loop the reduction buffer of half the warps reuses
// the first bytes
static size_t decode_smem(int row_bytes, int lut_bits, int k_chunk) {
  const size_t lut = lut_bits ? (32u << lut_bits) : 0u;
  const size_t ring =
      (size_t)kDecWarps * dec_stages(row_bytes) * (kDecUnit * row_bytes + 16);
  const size_t main = (lut + (size_t)k_chunk * kDecRows) * sizeof(float) + ring;
  const size_t red = (size_t)(kDecWarps / 2) * kDecRows * kDecStrip * 32 * sizeof(float);
  return main > red ? main : red;
}

constexpr int kMaxDevices = 64;

template <typename Src>
static int launch_decode(const void* x, int x_bf16, Src w, const float* scales,
                         float* part, float* y, int* counts, int M, int N, int K, int lb,
                         int k_chunk, int splits, int lut_bits, int vec, int async,
                         F2PConsts f, cudaStream_t stream) {
  auto k = dequant_matmul_decode_kernel<Src>;
  const size_t smem = decode_smem(16 * w.pieces(), lut_bits, k_chunk);
  // past the 48 KB default the kernel must opt in, on each device (the
  // attribute is the current device's)
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const dim3 grid((N + kDecCols - 1) / kDecCols, splits);
  k<<<grid, 32 * kDecWarps, smem, stream>>>(x, x_bf16, w, scales, part, y, counts, M, N, K,
                                            lb, k_chunk, splits, lut_bits, vec, async, f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dequant_matmul, tile route on the tensor cores (M > 8): the same function
// as dequant_matmul_kernel, y[M, N] f32 = x[M, K] @ (decode(code) * scale),
// on bf16 wgmma for the formats of at most 10 bits whose decoded values
// hold at most 8 significant bits (every format up to 9 bits; at 10 bits
// all but h = 1 LR / LI) and blocks of 16 rows or more. Replaces
// repro/kernels/f2p_matmul.py::_kernel (B8, UnpackedW) and ::_packed_kernel
// (B7, PackedW).
//
// Why it is exact enough. A decoded weight d (before its scale) holds at
// most 8 significant bits, so d * 2^-e_shift is a bf16 value exactly
// (e_shift puts the largest |d| in [0.5, 1), so that x * d' cannot
// overflow where x * d * s would not). An f32 x splits by truncation into
// x_hi + x_mid + x_lo, each of at most 8 significant bits (split3), and
// each product x_i * d' is exact in the f32 accumulator. The scale is per
// (K block, column), so y = sum_kb s'[kb, n] * sum_{k in kb} x * d', with
// s' = s * 2^e_shift: the tensor cores sum a block into blk, and at the
// block's end acc += s' * blk (one f32 FMA). The result differs from the
// plain version's order of rounding (w = d * s rounded first) at the f32
// rounding level only. What the split loses: bits of x below 2^-133
// (bf16's least subnormal; only for |x| < 2^-110), and tensor cores may
// flush subnormal products; both sit far below the tolerance. Two values
// near FLT_MAX in one row and one block can overflow blk where the plain
// version's sum of smaller products stays finite. inf and NaN in x go into
// x_hi alone (mid = lo = 0), so inf * d' gives inf as in the plain version,
// and not inf - inf = NaN.
//
// What bounds it. At M = 2048 with f32 x the tensor cores do 3 bf16 passes
// of 2 M N K; with bf16 x, 1. Around them each CTA stages, per K step of
// 64, its x tile (32 KB of f32 at 128 rows) and its codes from L2, and
// decodes the codes; on an H100 the staging, not the mma, sets the pace
// (tools/mm_bench.py ablate times the kernel with each part left out). At
// M = 16 to 128: the weight stream and the mma work of the 64-row minimum
// tile.
//
// The design. One CTA per (BM x kMmaCols) output tile and K chunk (grid
// z: K split as the SIMT kernel's, partials added in split order by
// sum_splits_kernel), BM = 64 or 128 rows, a template parameter: a
// warpgroup per 64 rows, each issuing wgmma.m64n128k16 (64 f32 sums in acc
// and 64 in blk per thread) with A from registers (warp w's 16 rows, in
// mma.sync's fragment layout) and B from a decoded W tile in shared
// memory. Per K step of 64 a ring of 3 (f32 x) or 4 (bf16 x) stages holds,
// filled with 16-byte cp.async copies (plain copies where a source is not
// 16-byte aligned; rows past M and columns past N read as zero): the x
// tile (f32 or bf16, rows padded to 72 elements: conflict-free fragment
// loads), the tile's codes (kMmaCols per K row: uint8, uint16 or nb-bit
// packed words, rows at an odd number of 16-byte units: conflict-free
// decode reads) and the scale rows of the blocks of its four k16 steps.
// One step ahead of the mma, every thread decodes 8-column units of codes
// through a table in shared memory (f2p_decode * 2^-e_shift as bf16 bits,
// each entry replicated per lane: 32 copies up to 8 bits, 2 above) into
// one of kMmaWBufs W tiles [64][128] bf16, laid out as wgmma's 8 x 8 core
// matrices without swizzle (k octet o, column octet c at o * 2048 + c *
// 128 bytes: the descriptor's LBO and SBO), written as whole 16-byte
// core-matrix rows. A K step: a __syncthreads; per k16 step, A fragments
// read (f32: split into three bf16 terms; a k16 step whose values hold inf
// or NaN, seen as a NaN rest, is split again with the non-finite rule) into
// one of two register buffers, the wgmmas issued (small terms first) and
// committed as a group; then, while they run, a quarter of the next step's
// decode (after the first k16 step also the ring's next fill). A group
// waits for the one before it only when its A buffer comes round again,
// and for all only where a block ends (blk is read) and at the end; with
// three W tiles, the one the next step decodes into is never one an mma in
// flight reads.
// ---------------------------------------------------------------------------
constexpr int kMmaBK = 64, kMmaMaxThreads = 256;
// ring stages: 3 of f32 x, 4 of bf16 x (within 227 KB at 128 rows)
template <typename TIn>
__host__ __device__ constexpr int mma_stages() { return sizeof(TIn) == 4 ? 3 : 4; }
constexpr int kMmaXPitch = kMmaBK + 8;      // elements of a staged x row
constexpr int kMmaK16 = kMmaBK / 16;        // mma K steps (and scale rows) a K step
constexpr int kMmaWTile = kMmaBK * kMmaCols;  // bf16 of a decoded W tile
constexpr int kMmaWBufs = 3;                // W tiles: in use, being decoded, in flight

__device__ __forceinline__ void PackedW::unit(const uint8_t* row, int nc,
                                              uint32_t* c) const {
  DecPacked{nullptr, 0, nb}.fields(row, c, nc);
}

struct MmaArgs {
  const void* x;          // [M, K], f32 or bf16
  const float* scales;    // [K / block, N]
  float* part;            // [splits, M, N] (y when splits is 1)
  int M, N, K, block, k_chunk, bm;
  int lut_bits, lrep;     // a table of 2^lut_bits codes x 2^lrep copies
  int e_shift;            // d' = d * 2^-e_shift, s' = s * 2^e_shift
  int async_x, async_w, async_s;   // 16-byte cp.async (else plain copies)
  int vec_out;            // float2 stores of y
  F2PConsts f;
};

extern __shared__ float4 mma_smem4[];

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d += A B for one warpgroup: A [64][16] bf16 from registers (this warp's
// 16 rows, mma.sync's fragment layout), B [16][128] bf16 by descriptor,
// N contiguous (the transposed form, the trailing 1); d in the m16n8
// accumulator layout per n8 chunk
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// no-swizzle descriptor of a [16 k][128 n] bf16 slab (B, N contiguous:
// wgmma's transposed B) whose 8 x 8 core matrices lie 2048 bytes apart
// along k (LBO) and 128 bytes along n (SBO)
__device__ __forceinline__ uint64_t mma_desc(const void* p) {
  const uint64_t a = (uint64_t)((__cvta_generic_to_shared(p) & 0x3FFFF) >> 4);
  return a | ((uint64_t)(2048 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

// 16 bytes into shared memory, n of them from src (the rest zero): one
// cp.async, or plain copies of kElem-byte elements
template <int kElem>
__device__ __forceinline__ void mma_copy16(void* dst, const void* src, const void* safe,
                                           int n, int async) {
  if (async) {
    cp_async16(dst, n > 0 ? src : safe, n);
    return;
  }
  uint8_t* d = reinterpret_cast<uint8_t*>(dst);
  const uint8_t* s = reinterpret_cast<const uint8_t*>(src);
#pragma unroll
  for (int e = 0; e < 16; e += kElem) {
    if constexpr (kElem == 1) d[e] = e < n ? s[e] : 0;
    if constexpr (kElem == 2)
      *reinterpret_cast<uint16_t*>(d + e) = e < n ? *reinterpret_cast<const uint16_t*>(s + e) : 0;
    if constexpr (kElem == 4)
      *reinterpret_cast<uint32_t*>(d + e) = e < n ? *reinterpret_cast<const uint32_t*>(s + e) : 0u;
  }
}

// x = hi + mid + lo for the two values of v, by truncation: hi keeps x's
// top 16 bits, mid those of the exact rest r = x - hi, lo those of r -
// mid, each at most 8 significant bits (a bf16 value); packed as bf16x2
// (the first value in the low half). Returns the rests' sum: NaN exactly
// when a value is inf or NaN (inf - inf), which split3_nonfinite handles.
__device__ __forceinline__ float split3(float2 v, uint32_t& hi, uint32_t& mid,
                                        uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(v.x), u1 = __float_as_uint(v.y);
  const float r0 = __fsub_rn(v.x, __uint_as_float(u0 & 0xFFFF0000u));
  const float r1 = __fsub_rn(v.y, __uint_as_float(u1 & 0xFFFF0000u));
  const uint32_t q0 = __float_as_uint(r0), q1 = __float_as_uint(r1);
  const float l0 = __fsub_rn(r0, __uint_as_float(q0 & 0xFFFF0000u));
  const float l1 = __fsub_rn(r1, __uint_as_float(q1 & 0xFFFF0000u));
  hi = __byte_perm(u0, u1, 0x7632);
  mid = __byte_perm(q0, q1, 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
  return __fadd_rn(r0, r1);
}

// split3 where a value may be inf or NaN: such a value goes into hi alone
// (a NaN kept a NaN by its quiet bit, its sign kept), mid = lo = 0
__device__ __forceinline__ void split3_nonfinite(float2 v, uint32_t& hi, uint32_t& mid,
                                                 uint32_t& lo) {
  split3(v, hi, mid, lo);
  const float e[2] = {v.x, v.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (isfinite(e[i])) continue;
    const uint32_t h = (__float_as_uint(e[i]) >> 16) | (isnan(e[i]) ? 0x40u : 0u);
    const uint32_t keep = i ? 0x0000FFFFu : 0xFFFF0000u;
    hi = (hi & keep) | (h << (16 * i));
    mid &= keep;
    lo &= keep;
  }
}

template <typename TIn, typename WSrc, int BM>
__global__ void __launch_bounds__(kMmaMaxThreads, 1)
dequant_matmul_mma_kernel(MmaArgs a, WSrc w) {
  constexpr bool kF32 = std::is_same<TIn, float>::value;
  constexpr int kXE = sizeof(TIn), kS = mma_stages<TIn>();
  constexpr int kXPieces = kMmaBK * kXE / 16;
  constexpr int nthr = 2 * BM;                  // a warpgroup per 64 rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x_bytes = BM * kMmaXPitch * kXE, c_pitch = w.pitch();
  const int stage_bytes = x_bytes + kMmaBK * c_pitch + kMmaK16 * kMmaCols * 4;
  uint32_t* lut = reinterpret_cast<uint32_t*>(mma_smem4);
  __nv_bfloat16* wdec = reinterpret_cast<__nv_bfloat16*>(lut + (1 << (a.lut_bits + a.lrep)));
  uint8_t* ring = reinterpret_cast<uint8_t*>(wdec + kMmaWBufs * kMmaWTile);

  const int n0 = blockIdx.x * kMmaCols, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * a.k_chunk, ke = min(a.K, kb + a.k_chunk);
  const int nsteps = (ke - kb) / kMmaBK;
  int cvalid;
  const uint8_t* cspan = w.span(blockIdx.x, cvalid);
  const long long cstride = w.stride();
  const int cpieces = w.pieces();
  const int svalid = min(kMmaCols, a.N - n0) * 4;

  auto fill = [&](int step) {
    uint8_t* st = ring + (step % kS) * stage_bytes;
    const int k0 = kb + step * kMmaBK;
#pragma unroll
    for (int i = tid; i < BM * kXPieces; i += nthr) {
      const int r = i / kXPieces, p = i - r * kXPieces, gm = m0 + r;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(a.x) +
                           ((size_t)min(gm, a.M - 1) * a.K + k0) * kXE + 16 * p;
      mma_copy16<kXE>(st + r * kMmaXPitch * kXE + 16 * p, src, a.x, gm < a.M ? 16 : 0,
                      a.async_x);
    }
    uint8_t* cs = st + x_bytes;
    for (int i = tid; i < kMmaBK * cpieces; i += nthr) {
      const int r = i / cpieces, p = i - r * cpieces;
      mma_copy16<WSrc::kElem>(cs + r * c_pitch + 16 * p, cspan + (k0 + r) * cstride + 16 * p,
                              cspan, min(max(cvalid - 16 * p, 0), 16), a.async_w);
    }
    uint8_t* ss = cs + kMmaBK * c_pitch;
    for (int i = tid; i < kMmaK16 * kMmaCols / 4; i += nthr) {
      const int h = i >> 5, p = i & 31;
      const float* src = a.scales + (size_t)((k0 + 16 * h) / a.block) * a.N + n0;
      mma_copy16<4>(ss + h * kMmaCols * 4 + 16 * p, src + 4 * p, a.scales,
                    min(max(svalid - 16 * p, 0), 16), a.async_s);
    }
  };

  // units [k0, k1) of a step: unit u is K row 8 (u >> 7) + (u & 7), columns
  // 8 ((u >> 3) & 15) + 0..7: one 16-byte row of a core matrix, at
  // (k / 8) 2048 + (n / 8) 128 + (k % 8) 16 bytes
  const uint32_t cmask = (1u << a.f.n_bits) - 1u, lsel = lane & ((1 << a.lrep) - 1);
  constexpr int kPer = kMmaBK * kMmaCols / 8 / nthr;
  auto decode = [&](int step, int k0, int k1) {
    const uint8_t* cs = ring + (step % kS) * stage_bytes + x_bytes;
    uint8_t* wd = reinterpret_cast<uint8_t*>(wdec + (step % kMmaWBufs) * kMmaWTile);
#pragma unroll
    for (int k = k0; k < k1; ++k) {
      const int u = tid + k * nthr;
      const int r = 8 * (u >> 7) + (u & 7), nc = (u >> 3) & 15;
      uint32_t c[8], v[8];
      w.unit(cs + r * c_pitch, nc, c);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = lut[((c[j] & cmask) << a.lrep) | lsel];
      *reinterpret_cast<uint4*>(wd + (r >> 3) * 2048 + nc * 128 + (r & 7) * 16) =
          make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                     __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
    }
  };

  for (int s = 0; s < kS - 1; ++s) {
    if (s < nsteps) fill(s);
    cp_async_commit();
  }
  {
    const int rep = 1 << a.lrep;
    const float down = exp2i(-a.e_shift);
    for (int c = tid; c < (1 << a.lut_bits); c += nthr) {
      const uint32_t d = __float_as_uint(__fmul_rn(f2p_decode((uint32_t)c, a.f), down)) >> 16;
      for (int j = 0; j < rep; ++j) lut[(c << a.lrep) + ((j + lane) & (rep - 1))] = d;
    }
  }
  cp_async_wait<kS - 2>();
  __syncthreads();
  decode(0, 0, kPer);

  // warp w: rows 16 w .. 16 w + 15 of the CTA (warpgroup w / 4 takes 64)
  const int g = lane >> 2, t = lane & 3;
  const float up = exp2i(a.e_shift);
  float acc[64], blk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = blk[i] = 0.0f;

  auto steps = [&](auto small) {
    constexpr bool kSmall = decltype(small)::value;
    for (int step = 0; step < nsteps; ++step) {
      cp_async_wait<kS - 3>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const uint8_t* st = ring + (step % kS) * stage_bytes;
      const TIn* xs = reinterpret_cast<const TIn*>(st) + warp * 16 * kMmaXPitch;
      const float* ss = reinterpret_cast<const float*>(st + x_bytes + kMmaBK * c_pitch);
      const __nv_bfloat16* wd = wdec + (step % kMmaWBufs) * kMmaWTile;
      const int k0 = kb + step * kMmaBK;
      uint32_t ah[2][4];
      [[maybe_unused]] uint32_t am[2][4], al[2][4];
#pragma unroll
      for (int h = 0; h < kMmaK16; ++h) {
        const int kk = 16 * h, buf = h & 1;
        wgmma_wait<1>();   // the group that read this A buffer is done
        if constexpr (kF32) {
          float chk = 0.0f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = *reinterpret_cast<const float2*>(
                xs + (g + 8 * (q & 1)) * kMmaXPitch + kk + 2 * t + 8 * (q >> 1));
            chk = __fadd_rn(chk, split3(v, ah[buf][q], am[buf][q], al[buf][q]));
          }
          if (isnan(chk)) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 v = *reinterpret_cast<const float2*>(
                  xs + (g + 8 * (q & 1)) * kMmaXPitch + kk + 2 * t + 8 * (q >> 1));
              split3_nonfinite(v, ah[buf][q], am[buf][q], al[buf][q]);
            }
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            ah[buf][q] = *reinterpret_cast<const uint32_t*>(
                xs + (g + 8 * (q & 1)) * kMmaXPitch + kk + 2 * t + 8 * (q >> 1));
        }
        const uint64_t desc = mma_desc(wd + h * 2048);   // 2 k octets of 1024 bf16
        wgmma_fence();
        if constexpr (kF32) {
          wgmma_m64n128(blk, al[buf], desc);
          wgmma_m64n128(blk, am[buf], desc);
        }
        wgmma_m64n128(blk, ah[buf], desc);
        wgmma_commit();
        if (h == 0) {   // the ring's next fill, behind this step's first mma
          if (step + kS - 1 < nsteps) fill(step + kS - 1);
          cp_async_commit();
        }
        decode(step + 1, h * kPer / kMmaK16, (h + 1) * kPer / kMmaK16);
        const int kn = k0 + kk + 16;
        if ((kSmall || h == kMmaK16 - 1) && ((kn & (a.block - 1)) == 0 || kn == ke)) {
          wgmma_wait<0>();
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 s = *reinterpret_cast<const float2*>(ss + h * kMmaCols + 8 * j + 2 * t);
            const float s0 = __fmul_rn(s.x, up), s1 = __fmul_rn(s.y, up);
            acc[4 * j] = fmaf(s0, blk[4 * j], acc[4 * j]);
            acc[4 * j + 1] = fmaf(s1, blk[4 * j + 1], acc[4 * j + 1]);
            acc[4 * j + 2] = fmaf(s0, blk[4 * j + 2], acc[4 * j + 2]);
            acc[4 * j + 3] = fmaf(s1, blk[4 * j + 3], acc[4 * j + 3]);
            blk[4 * j] = blk[4 * j + 1] = blk[4 * j + 2] = blk[4 * j + 3] = 0.0f;
          }
        }
      }
    }
    wgmma_wait<0>();
  };
  if (a.block < kMmaBK)
    steps(std::true_type{});
  else
    steps(std::false_type{});

  float* out = a.part + (size_t)blockIdx.z * a.M * a.N;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gm = m0 + warp * 16 + g + 8 * hr;
    if (gm >= a.M) continue;
    float* o = out + (size_t)gm * a.N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gn = n0 + 8 * j + 2 * t;
      if (a.vec_out && gn + 1 < a.N) {
        *reinterpret_cast<float2*>(o + gn) = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
      } else {
        if (gn < a.N) o[gn] = acc[4 * j + 2 * hr];
        if (gn + 1 < a.N) o[gn + 1] = acc[4 * j + 2 * hr + 1];
      }
    }
  }
}

template <typename TIn, typename WSrc>
static size_t mma_smem(const MmaArgs& a, const WSrc& w) {
  const size_t stage = (size_t)a.bm * kMmaXPitch * sizeof(TIn) +
                       (size_t)kMmaBK * w.pitch() + kMmaK16 * kMmaCols * 4;
  return (4u << (a.lut_bits + a.lrep)) + kMmaWBufs * kMmaBK * kMmaCols * 2 +
         mma_stages<TIn>() * stage;
}

template <typename TIn, typename WSrc, int BM>
static int launch_mma(MmaArgs a, WSrc w, int splits, cudaStream_t stream) {
  auto k = dequant_matmul_mma_kernel<TIn, WSrc, BM>;
  const size_t smem = mma_smem<TIn>(a, w);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  a.async_w = w.aligned();
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const dim3 grid((a.N + kMmaCols - 1) / kMmaCols, (a.M + BM - 1) / BM, splits);
  k<<<grid, 2 * BM, smem, stream>>>(a, w);
  return (int)cudaGetLastError();
}

template <typename WSrc>
static int launch_mma_in(int x_bf16, const MmaArgs& a, WSrc w, int splits,
                         cudaStream_t stream) {
  if (x_bf16)
    return a.bm == 64 ? launch_mma<__nv_bfloat16, WSrc, 64>(a, w, splits, stream)
                      : launch_mma<__nv_bfloat16, WSrc, 128>(a, w, splits, stream);
  return a.bm == 64 ? launch_mma<float, WSrc, 64>(a, w, splits, stream)
                    : launch_mma<float, WSrc, 128>(a, w, splits, stream);
}

// ---------------------------------------------------------------------------
// attention over packed KV (B1 paged, B2 dense): a split-KV decode kernel
//
// Replaces repro/kernels/f2p_attention.py::_paged_kernel (paged: [P, T, K,
// W] slabs read through a [B, maxp] page table) and ::_fused_kernel (dense
// [B, S, K, W]); one kernel, the addressing mode chosen at run time.
//
// What bounds it. Decode attention moves every live packed K/V word and
// scale once (about 2 * (hd * n_bits / 8 + 4) bytes per position and kv
// head) and does 4 R hd f32 operations per position, so at R = 3 it is
// bound by bytes and, on the way, by instruction issue: each element is
// cut from its word, decoded, scaled and used in R FMAs (about 60
// instructions per position and warp). What it must not be bound by is
// latency: at the serving lengths (64 to 1024 positions) one (batch row,
// kv head) holds too little work for one CTA, or for one warp.
//
// The design.
// - Split KV. The grid is (split, kv head x row group, batch row). A CTA
//   takes `tile` consecutive positions (a run-time multiple of kAttnChunk,
//   128 by default: f2p_attention.attention_tile), walked in passes of
//   kAttnPass = kAttnChunk x kAttnWarps: in pass i warp w takes the chunk
//   at i * kAttnPass + kAttnChunk * w, position + lane, lanes past the
//   chunk idle there, and keeps its own online (m, l, acc) across its
//   chunks (the first chunk's taken as it is, so one pass is bitwise the
//   one-chunk warp). Splits, passes and warps past a row's kv_len do
//   nothing, and no K/V word past kv_len is read, so the result is a
//   function of the row's kv_len, the words below it and the tile only:
//   not of S, the span bucket, B or the SM count. Dense and paged run the
//   same loop on the same words, so paged == dense bitwise at one tile.
// - Row groups. The R = G * Sq folded query rows are cut into ng groups of
//   RG = 3 or 4 rows (a template parameter), one group per CTA: the q rows
//   and sums of a lane stay in registers. Rows past R (R < 3, or a last
//   group not full) load q = 0 and are not stored.
// - Staging. Each warp reads its positions' page ids (lanes of one page
//   read one address, issued with the kv_len load), then copies its K rows
//   and scales, and its V rows and scales, into shared memory as two
//   cp.async groups (16-byte pieces where rows are 16-byte aligned, else
//   4-byte), so the warp's bytes are all in flight at once while the CTA
//   builds the decode tables; V lands during QK. Each warp stages one
//   chunk a pass, whole, after the last pass is done with the stage: there
//   is no ring, so a tile of several passes waits for each chunk's bytes
//   (between passes the warp's (m, l) and acc wait in shared memory, so
//   that the registers of QK are those of one pass).
// - Decode once per element, in registers. Lane l owns D = hd / 32 (1, 2
//   or 4) consecutive dims: it cuts their fields out of a window of 1-3
//   words at a fixed bit offset, decodes each through a table (n_bits <=
//   8: every payload code, replicated once per bank, entry c of lane l at
//   32 c + l, so random codes never collide; the sign bit of a signed
//   format flips the value's sign bit) or f2p_decode (above 8 bits), and
//   multiplies by the position's scale with __fmul_rn, as the plain
//   version does. The table and f2p_decode get a loop each: with a select
//   per element the compiler runs both.
// - QK without serial chains: each lane forms D-long partial dots for 8
//   positions x RG rows, then a transposing butterfly (xor 16, 8, 4 keep
//   half of the values, xor 2, 1 add) leaves the full dot of position
//   (lane >> 2) & 7 in lanes 4k..4k+3: 9 shuffles per row per 8
//   positions. A lane then holds its own position's score; the softmax
//   max and sum are warp reductions (-inf guarded as the reference's
//   _online_step), and p goes to shared memory.
// - PV: lanes own dims; each lane decodes only its own V fields and runs
//   RG x D FMAs per position, reading p as one broadcast 16-byte load.
// - Merges in a fixed order. The CTA merges its warps' (acc, m, l) in
//   warp order; with one live split it writes o, else the split's partial
//   goes to the workspace and the last CTA of the (row, head, group) to
//   finish (an atomic count, reset by that CTA, as the matmul's decode
//   route does) merges the partials in split order. That costs no second
//   launch, and no host step between two. Every merge is m = max m_i,
//   o = sum_i acc_i exp(m_i - m) / max(sum_i l_i exp(m_i - m), 1e-37),
//   in f32 with expf and no fast math; the factors exp(m_i - m) are
//   computed once per row. Any number of splits: the max is a block-wide
//   reduction (exact in any order), then the factors go through shared
//   memory in chunks of as many splits as the warp regions hold, and L
//   and o run on across chunks in split order, so up to one chunk's worth
//   the arithmetic is the one-chunk merge's.
// - q is read in its caller layout [B, Sq, H, hd] and dtype (f32 or bf16,
//   strided), and o written as [B, Sq, H, hd] in that dtype
//   (__float2bfloat16_rn, what .to(torch.bfloat16) gives): no fold or
//   unfold launches around the call. kv_len = 0 writes exact zeros.
// No tensor cores: at R = 3 a decode call fills 3 of an mma's 16 rows, and
// bf16 or TF32 inputs would break the 1e-5 f32 tolerance.
// ---------------------------------------------------------------------------
constexpr int kAttnRows = 4;        // most query rows one CTA holds
constexpr int kAttnChunk = 16;      // positions per warp chunk; the tile's unit
constexpr int kAttnWarps = 8;
constexpr int kAttnPass = kAttnChunk * kAttnWarps;   // positions a pass of the warps covers
constexpr int kAttnMaxThreads = 32 * kAttnWarps;

// kv_len or q_offset: an int32 / int64 tensor read at b * stride (stride 0:
// one value for every row), or `value` when p is null
struct AttnArgs {
  const void* q;             // [B, Sq, H, hd] f32 | bf16, dims contiguous
  long long qsb, qss, qsh;   // its strides, in elements
  const uint32_t* kw;        // dense [B, S, K, Wk] | paged [P, T, K, Wk]
  const float* ks;           // one scale per row of words
  const uint32_t* vw;
  const float* vs;
  const int* pages;          // paged: [B, maxp]; dense: null
  void* out;                 // [B, Sq, H, hd], q's dtype
  float* part;               // split partials [B * K * ng, nsplit, RG * hd + 2 RG]
  int* counts;               // finished splits per (b, h, group), 0 between launches
  AttnLen kvlen, qoff;
  int bf16, Sq, H, K, G, R, hd, S, T, P, maxp, causal, ng;
  int tile;                  // positions per CTA, a multiple of kAttnChunk
  int Wk, Wv, win_k, win_v, vec_k, vec_v;
  int tab_k, tab_v;          // table bits (n_bits <= 8); 0: f2p_decode
  int tv_off, build_v;       // V's table: its offset; 0 when it is K's
  int tables, kreg, vreg;    // floats: the tables, a warp's K and V stages
  int warp_floats;           // one warp's region
  float scale;
  F2PConsts fk, fv;
};

// a warp's region, after the tables: K stage (then the warp's acc [RG][hd]),
// V stage, and for up to 32 positions row indices, K and V scales and p
// [32][4], then m [4] and l [4], then (a tile of more than one pass) the
// stash of its acc between passes [RG][hd]
__host__ __device__ constexpr int attn_misc_floats() { return 32 * 3 + 32 * 4 + 8; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// copy the rows of words of the warp's n positions into its stage (row t at
// t * W words): 16-byte pieces, or 4-byte ones where rows are not aligned
__device__ __forceinline__ void attn_stage(uint32_t* dst, const uint32_t* __restrict__ src,
                                           int W, int vec, const int* rows, int n, int lane) {
  const int pieces = vec ? W >> 2 : W;
  const float inv = 1.0f / (float)pieces;
  for (int e = lane; e < n * pieces; e += 32) {
    // e / pieces: exact, the quotient's distance from a boundary (>= 0.5 /
    // pieces) is far above the float error (n * pieces <= 32 * 64)
    const int t = (int)(((float)e + 0.5f) * inv);
    const int o = e - t * pieces;
    const uint32_t* s = src + (size_t)rows[t] * W;
    if (vec)
      cp_async16(dst + t * W + 4 * o, s + 4 * o, 16);
    else
      cp_async4(dst + t * W + o, s + o);
  }
}

// the D fields of a lane from its window of `win` words at word w0 of a
// staged row, the first field at bit sh of word w0 (D * nb <= 64)
template <int D>
__device__ __forceinline__ void attn_fields(const uint32_t* row, int w0, int sh, int win,
                                            int nb, uint32_t (&c)[D]) {
  const uint32_t a = row[w0];
  const uint32_t b = win > 1 ? row[w0 + 1] : 0u;
  const uint32_t e = win > 2 ? row[w0 + 2] : 0u;
  const uint64_t x = ((uint64_t)__funnelshift_r(b, e, sh) << 32) | __funnelshift_r(a, b, sh);
  const uint32_t mask = (1u << nb) - 1u;
#pragma unroll
  for (int j = 0; j < D; ++j) c[j] = (uint32_t)(x >> (j * nb)) & mask;
}

// a lane's D values of a staged row: decode(field) * the position's scale
// (0 for a lane past head_dim). TAB: n_bits <= 8, so the fields lie in the
// low 32 bits of the window and decode through the table, which holds the
// payload codes only for a signed format: the sign bit flips the value's,
// bitwise what f2p_decode's negation gives (-0.0 for 0)
template <int D, bool TAB>
__device__ __forceinline__ void attn_values(const uint32_t* row, int w0, int sh, int win,
                                            int nb, const float* tab, int lane,
                                            const F2PConsts& f, float sc, bool live,
                                            float (&v)[D]) {
  if constexpr (TAB) {
    const uint32_t a = row[w0];
    const uint32_t x = win > 1 ? __funnelshift_r(a, row[w0 + 1], sh) : a >> sh;
    const uint32_t tmask = (1u << (f.is_signed ? f.nu : nb)) - 1u;
    const uint32_t smask = f.is_signed ? 0x80000000u : 0u;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const uint32_t c = x >> (j * nb);
      const uint32_t flip = (c << (31 - f.nu)) & smask;
      v[j] = __fmul_rn(__uint_as_float(__float_as_uint(tab[((c & tmask) << 5) + lane]) ^ flip),
                       sc);
    }
  } else {
    uint32_t c[D];
    attn_fields<D>(row, w0, sh, win, nb, c);
#pragma unroll
    for (int j = 0; j < D; ++j) v[j] = __fmul_rn(f2p_decode(c[j], f), sc);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) v[j] = live ? v[j] : 0.0f;
}

// the value of every code below 2^bits, replicated 32 times (entry c of
// lane l at 32 c + l)
__device__ __forceinline__ void attn_table(float* tab, int bits, const F2PConsts& f) {
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < (1 << bits); c += blockDim.x) {
    const float d = f2p_decode((uint32_t)c, f);
    float4* row = reinterpret_cast<float4*>(tab + (c << 5));
#pragma unroll
    for (int j = 0; j < 8; ++j) row[(j + lane) & 7] = make_float4(d, d, d, d);
  }
}

// 8 partial dots of a lane -> the warp's sum for position (lane >> 2) & 7
__device__ __forceinline__ float attn_reduce8(const float (&v)[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
  float u[4], w[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = (h16 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, h16 ? v[k] : v[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    w[k] = (h8 ? u[k + 2] : u[k]) + __shfl_xor_sync(0xffffffffu, h8 ? u[k] : u[k + 2], 8);
  float x = (h4 ? w[1] : w[0]) + __shfl_xor_sync(0xffffffffu, h4 ? w[0] : w[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

__device__ __forceinline__ void attn_store(const AttnArgs& a, int b, int h, int row, int d,
                                           float v) {
  if (row >= a.R) return;
  const int g = row / a.Sq, s = row - g * a.Sq;
  const size_t o = (((size_t)b * a.Sq + s) * a.H + h * a.G + g) * a.hd + d;
  if (a.bf16)
    reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(a.out)[o] = v;
}

extern __shared__ float4 attn_smem4[];

// CTAs an SM asked of the compiler. One pass (MULTI false) fits 64
// registers, four CTAs an SM, but for 4 rows of 4 dims a lane (the
// accumulators of 16 values); MULTI (a tile of several passes) holds q,
// the stage pointers and the pass's state across its loop: two, so that a
// long call's many CTAs do not run one an SM (on an H100 at 700 W a
// one-pass CTA of 96-107 registers ran 10-15% slower at the serving shape
// than one of 64)
__host__ __device__ constexpr int attn_min_ctas(int rg, int d, bool multi) {
  return multi || (rg == 4 && d == 4) ? 2 : 4;
}
template <int RG, int D, bool MULTI>
__global__ void __launch_bounds__(kAttnMaxThreads, attn_min_ctas(RG, D, MULTI))
attention_decode_kernel(AttnArgs a) {
  float* smem = reinterpret_cast<float*>(attn_smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = kAttnWarps;
  const int L = a.tile;
  const int split = blockIdx.x, b = blockIdx.z;
  const int h = blockIdx.y / a.ng, grp = blockIdx.y - h * a.ng, r0 = grp * RG;
  const int bhg = (b * a.K + h) * a.ng + grp;
  const int hdg = RG * a.hd;
  const long long s0 = (long long)split * L;   // the split's first position
  int c0 = (int)s0 + warp * kAttnChunk;   // s0 < S: the grid covers S
  // the page id goes out with the kv_len load (ids past S are not read)
  int pid = 0;
  if (a.pages && lane < kAttnChunk && c0 + lane < a.S)
    pid = __ldg(a.pages + (size_t)b * a.maxp + (c0 + lane) / a.T);
  const int kvlen = (int)max(0LL, min(attn_len(a.kvlen, b), (long long)a.S));
  // splits past the row's kv_len do nothing (no division: a 64-bit one
  // costs the kernel registers)
  if (s0 >= max(kvlen, 1)) return;
  if (kvlen == 0) {                     // kv_len <= 0: exact zeros
    for (int i = threadIdx.x; i < hdg; i += blockDim.x)
      attn_store(a, b, h, r0 + i / a.hd, i % a.hd, 0.0f);
    return;
  }
  // the live end of this split: chunks never cross it (the tile is whole
  // chunks)
  const int end = (int)min((long long)kvlen, s0 + L);
  float* wr = smem + a.tables + warp * a.warp_floats;
  uint32_t* kraw = reinterpret_cast<uint32_t*>(wr);
  uint32_t* vraw = kraw + a.kreg;
  int* rows = reinterpret_cast<int*>(vraw + a.vreg);
  float* ksc = reinterpret_cast<float*>(rows + 32);
  float* vsc = ksc + 32;
  float* pb = vsc + 32;   // [32][4]
  float* ml = pb + 128;   // m [4], l [4]

  // stage the n live positions of the warp's chunk at c0: K rows and
  // scales, then V's (the scales of positions past n are 0, so a stale
  // word there decodes to 0), as two cp.async groups
  auto stage = [&](int n) {
    if (lane < n) {
      const int pos = c0 + lane;
      long long row;
      if (a.pages) {
        pid = min(max(pid, 0), a.P - 1);   // a garbage id stays inside the slab
        row = ((long long)pid * a.T + pos % a.T) * a.K + h;
      } else {
        row = ((long long)b * a.S + pos) * a.K + h;
      }
      rows[lane] = (int)row;
    } else {
      ksc[lane] = 0.0f;
      vsc[lane] = 0.0f;
    }
    __syncwarp();
    attn_stage(kraw, a.kw, a.Wk, a.vec_k, rows, n, lane);
    if (lane < n) cp_async4(ksc + lane, a.ks + rows[lane]);
    cp_async_commit();
    attn_stage(vraw, a.vw, a.Wv, a.vec_v, rows, n, lane);
    if (lane < n) cp_async4(vsc + lane, a.vs + rows[lane]);
    cp_async_commit();
  };
  int n = max(0, min(kAttnChunk, end - c0));
  stage(n);

  // while the copies fly: the tables and this lane's q (its D dims of RG rows)
  if (a.tab_k) attn_table(smem, a.tab_k, a.fk);
  if (a.build_v) attn_table(smem + a.tv_off, a.tab_v, a.fv);
  const float* tabk = a.tab_k ? smem : nullptr;
  const float* tabv = a.tab_v ? smem + a.tv_off : nullptr;
  const int dl = lane * D;
  const bool live_lane = dl < a.hd;
  float qr[RG][D];
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int row = r0 + r;
#pragma unroll
    for (int j = 0; j < D; ++j) qr[r][j] = 0.0f;
    if (row < a.R && live_lane) {
      const int g = row / a.Sq, s = row - g * a.Sq;
      const size_t o = b * a.qsb + s * a.qss + (h * a.G + g) * a.qsh + dl;
#pragma unroll
      for (int j = 0; j < D; ++j)
        qr[r][j] = a.bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.q)[o + j])
                          : reinterpret_cast<const float*>(a.q)[o + j];
    }
  }
  cp_async_wait<1>();
  __syncthreads();   // the tables are built, every warp's first K stage has landed

  const int nbk = a.fk.n_bits, bitk = dl * nbk;
  const int wk0 = live_lane ? bitk >> 5 : 0, shk = bitk & 31;
  // The warp's chunks, one a pass (MULTI; else the one chunk, and the loop
  // body runs once). Between passes its running (m, l)
  // waits in ml and its acc in the stash, not in registers, so that QK
  // holds no more registers than with one pass. A chunk's scores are
  // exponentiated against the running max, and the acc so far, rescaled
  // by exp(m_old - m), is where PV starts; the first pass starts from m =
  // -inf and acc = 0, the arithmetic of a one-chunk warp.
  float* stash = ml + 8;   // [RG][hd] (a.tile > kAttnPass only)
  for (int pass = 0;; ++pass) {
    // QK: lane t ends with the scores of position c0 + t. The table and
    // f2p_decode get a loop each: a select per element would run both.
    // Positions past n in a group read stale stage words; their scores are
    // masked below, and each position's dot is summed apart.
    float s[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) s[r] = 0.0f;
    auto qk = [&](auto table) {
      constexpr bool TAB = decltype(table)::value;
#pragma unroll
      for (int gi = 0; gi < kAttnChunk / 8; ++gi) {
        if (gi * 8 >= n) break;
        float pd[RG][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = gi * 8 + k;
          float kv[D];
          attn_values<D, TAB>(kraw + t * a.Wk, wk0, shk, a.win_k, nbk, tabk, lane, a.fk, ksc[t],
                              live_lane, kv);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            pd[r][k] = 0.0f;
#pragma unroll
            for (int j = 0; j < D; ++j) pd[r][k] = fmaf(qr[r][j], kv[j], pd[r][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float x = __shfl_sync(0xffffffffu, attn_reduce8(pd[r], lane), (lane & 7) << 2);
          if ((lane >> 3) == gi) s[r] = x;
        }
      }
    };
    if (tabk)
      qk(std::true_type());
    else
      qk(std::false_type());

    // softmax over the chunk's positions, one row at a time, against the
    // running max
    const long long qo = a.causal ? attn_len(a.qoff, b) : 0;
    float m[RG], l[RG], co[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      bool valid = lane < n;
      if (a.causal) valid = valid && (long long)(c0 + lane) <= qo + (r0 + r) % a.Sq;
      const float sv = valid ? s[r] * a.scale : -INFINITY;
      float mx = sv;
#pragma unroll
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mold = pass ? ml[r] : -INFINITY;
      const float M = fmaxf(mold, mx);
      const float safe = isfinite(M) ? M : 0.0f;
      const float p = expf(sv - safe);
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pb[lane * 4 + r] = p;
      co[r] = isfinite(mold) ? expf(mold - safe) : 0.0f;
      l[r] = pass ? fmaf(ml[4 + r], co[r], sum) : sum;
      m[r] = M;
    }
    cp_async_wait<0>();
    __syncwarp();   // the V stage has landed, p is visible, ml has been read

    // PV: lane l's dims, positions in order, onto the rescaled acc; groups
    // of 8 positions; past n, p = 0 and the value is 0 (scale 0)
    const int nbv = a.fv.n_bits, bitv = dl * nbv;
    const int wv0 = live_lane ? bitv >> 5 : 0, shv = bitv & 31;
    float acc[RG][D];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
      for (int j = 0; j < D; ++j)
        acc[r][j] = pass && live_lane ? stash[r * a.hd + dl + j] * co[r] : 0.0f;
    auto pv = [&](auto table) {
      constexpr bool TAB = decltype(table)::value;
#pragma unroll
      for (int gi = 0; gi < kAttnChunk / 8; ++gi) {
        if (gi * 8 >= n) break;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int t = gi * 8 + k;
          float v[D];
          attn_values<D, TAB>(vraw + t * a.Wv, wv0, shv, a.win_v, nbv, tabv, lane, a.fv,
                              vsc[t], live_lane, v);
          const float4 p4 = reinterpret_cast<const float4*>(pb)[t];
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int j = 0; j < D; ++j)
#pragma unroll
            for (int r = 0; r < RG; ++r) acc[r][j] = fmaf(pr[r], v[j], acc[r][j]);
        }
      }
    };
    if (tabv)
      pv(std::true_type());
    else
      pv(std::false_type());

    // the warp's next chunk, one pass on (warp-uniform: every lane agrees);
    // the state goes to ml and to the stash (the last pass: its acc to the
    // spent K stage, where the CTA merge reads it)
    c0 += kAttnPass;
    n = MULTI ? max(0, min(kAttnChunk, end - c0)) : 0;
    __syncwarp();   // every lane is done with the stages, scales and p
    float* dst = n ? stash : wr;
    if (live_lane)
#pragma unroll
      for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int j = 0; j < D; ++j) dst[r * a.hd + dl + j] = acc[r][j];
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        ml[r] = m[r];
        ml[4 + r] = l[r];
      }
    if (n == 0) break;
    if (a.pages && lane < n) pid = __ldg(a.pages + (size_t)b * a.maxp + (c0 + lane) / a.T);
    stage(n);
    cp_async_wait<1>();
    __syncwarp();   // the K stage has landed, the state is visible
  }
  __syncthreads();

  // the CTA's warps, merged in warp order: one thread per row finds the
  // max and each warp's factor exp(m_w - max) once, then every element is
  // a sum of FMAs in warp order
  __shared__ float cf[(kAttnMaxThreads / 32) * kAttnRows];   // [warp][row]
  __shared__ float mlt[2 * kAttnRows];                        // max, sum per row
  __shared__ int last;
  const int base = blockIdx.x * a.tile;   // s0, recomputed: nothing held across the passes
  const int live = min(nw, (min(kvlen - base, a.tile) + kAttnChunk - 1) / kAttnChunk);
  const int mo = a.kreg + a.vreg + 32 * 3 + 128;   // ml's offset in a region
  float* w0 = smem + a.tables;
  if (threadIdx.x < RG) {
    const int r = threadIdx.x;
    float M = -INFINITY;
    for (int w = 0; w < live; ++w) M = fmaxf(M, w0[w * a.warp_floats + mo + r]);
    const float safe = isfinite(M) ? M : 0.0f;
    float Ls = 0.0f;
    for (int w = 0; w < live; ++w) {
      const float mw = w0[w * a.warp_floats + mo + r];
      const float c = isfinite(mw) ? expf(mw - safe) : 0.0f;
      cf[w * kAttnRows + r] = c;
      Ls = fmaf(w0[w * a.warp_floats + mo + 4 + r], c, Ls);
    }
    mlt[r] = M;
    mlt[kAttnRows + r] = Ls;
  }
  __syncthreads();
  const size_t ps = (size_t)hdg + 2 * RG;
  const bool one = kvlen <= a.tile;     // the row's only split writes o
  float* mine = one ? nullptr : a.part + ((size_t)bhg * gridDim.x + split) * ps;
  for (int i = threadIdx.x; i < hdg; i += blockDim.x) {
    const int r = i / a.hd, d = i - r * a.hd;
    float O = 0.0f;
    for (int w = 0; w < live; ++w) O = fmaf(w0[w * a.warp_floats + i], cf[w * kAttnRows + r], O);
    if (one)
      attn_store(a, b, h, r0 + r, d, O / fmaxf(mlt[kAttnRows + r], 1e-37f));
    else
      mine[i] = O;
  }
  if (one) return;
  if (threadIdx.x < RG) {
    mine[hdg + threadIdx.x] = mlt[threadIdx.x];
    mine[hdg + RG + threadIdx.x] = mlt[kAttnRows + threadIdx.x];
  }

  // the last CTA of this (row, head, group) to finish merges the partials
  // in split order, the same way, for any number of splits
  const int ns = (int)(((unsigned)kvlen + (unsigned)L - 1u) / (unsigned)L);   // live splits
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counts + bhg, 1) == ns - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) a.counts[bhg] = 0;   // ready for the next launch on this stream
  const float* pp = a.part + (size_t)bhg * gridDim.x * ps;
  // The (m, l) of up to `cap` splits at a time go to the warp regions
  // ([j]: m, then l, per row; m then becomes the split's factor). M, the
  // max over every split: with one chunk, thread r takes it from there (as
  // the one-chunk merge always did); with more, every thread's max over its
  // splits, then over the warps, first (fmaxf is exact, so the order does
  // not matter; the sign of a zero M may, but m_j - M and so every factor
  // is the same either way). L (thread r) and each o element (its thread,
  // 8 partials in flight, its sum waiting in osum between chunks) run on
  // in split order across the chunks.
  float* sml = w0;
  float* osum = w0 + nw * a.warp_floats - hdg;
  const int cap = (nw * a.warp_floats - hdg) / (2 * RG);
  if (ns > cap) {
    float mx[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) mx[r] = -INFINITY;
    for (int j = threadIdx.x; j < ns; j += blockDim.x)
#pragma unroll
      for (int r = 0; r < RG; ++r) mx[r] = fmaxf(mx[r], __ldcg(pp + j * ps + hdg + r));
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      if (lane == 0) cf[warp * kAttnRows + r] = mx[r];
    }
    __syncthreads();
    if (threadIdx.x < RG) {
      float M = -INFINITY;
      for (int w = 0; w < nw; ++w) M = fmaxf(M, cf[w * kAttnRows + threadIdx.x]);
      mlt[threadIdx.x] = isfinite(M) ? M : 0.0f;
    }
  }
  float Ls = 0.0f;
  for (int c = 0; c < ns; c += cap) {
    const int nc = min(cap, ns - c);
    for (int e = threadIdx.x; e < nc * 2 * RG; e += blockDim.x) {
      const int j = e / (2 * RG);
      sml[e] = __ldcg(pp + (size_t)(c + j) * ps + hdg + (e - j * 2 * RG));
    }
    __syncthreads();
    if (ns <= cap) {
      if (threadIdx.x < RG) {
        float M = -INFINITY;
        for (int j = 0; j < nc; ++j) M = fmaxf(M, sml[j * 2 * RG + threadIdx.x]);
        mlt[threadIdx.x] = isfinite(M) ? M : 0.0f;
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < nc * RG; e += blockDim.x) {
      const int j = e / RG, r = e - j * RG;
      const float mj = sml[j * 2 * RG + r];
      sml[j * 2 * RG + r] = isfinite(mj) ? expf(mj - mlt[r]) : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < RG)
      for (int j = 0; j < nc; ++j)
        Ls = fmaf(sml[j * 2 * RG + RG + threadIdx.x], sml[j * 2 * RG + threadIdx.x], Ls);
    for (int i = threadIdx.x; i < hdg; i += blockDim.x) {
      const int r = i / a.hd;
      const float* pi = pp + (size_t)c * ps + i;
      float O = c ? osum[i] : 0.0f;
      for (int j0 = 0; j0 < nc; j0 += 8) {
        float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = j0 + q < nc ? __ldcg(pi + (j0 + q) * ps) : 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (j0 + q < nc) O = fmaf(o[q], sml[(j0 + q) * 2 * RG + r], O);
      }
      osum[i] = O;
    }
    __syncthreads();
  }
  if (threadIdx.x < RG) mlt[kAttnRows + threadIdx.x] = Ls;
  __syncthreads();
  for (int i = threadIdx.x; i < hdg; i += blockDim.x) {
    const int r = i / a.hd, d = i - r * a.hd;
    attn_store(a, b, h, r0 + r, d, osum[i] / fmaxf(mlt[kAttnRows + r], 1e-37f));
  }
}

template <int RG, int D, bool MULTI>
static int launch_attention(const AttnArgs& a, dim3 grid, int threads, size_t smem,
                            cudaStream_t stream) {
  auto k = attention_decode_kernel<RG, D, MULTI>;
  static size_t opted[kMaxDevices] = {};   // past 48 KB, once per device and size
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  k<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// MULTI: a tile of more than one pass (the loop over a warp's chunks);
// one pass is its own instance, straight-line code with the registers of
// one chunk
template <int D>
static int launch_attention_rg(int rg, const AttnArgs& a, dim3 grid, int threads,
                               size_t smem, cudaStream_t stream) {
  if (a.tile > kAttnPass)
    return rg == 3 ? launch_attention<3, D, true>(a, grid, threads, smem, stream)
                   : launch_attention<4, D, true>(a, grid, threads, smem, stream);
  return rg == 3 ? launch_attention<3, D, false>(a, grid, threads, smem, stream)
                 : launch_attention<4, D, false>(a, grid, threads, smem, stream);
}

// words of the widest lane window: D fields of nb bits from bit l * D * nb
static int attn_window(int hd, int D, int nb) {
  int win = 1;
  for (int l = 0; l * D < hd; ++l) {
    const int sh = (l * D * nb) & 31;
    win = max(win, (sh + D * nb + 31) / 32);
  }
  return win;
}

// ---------------------------------------------------------------------------
// B5 / B6 launchers
// ---------------------------------------------------------------------------
static int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (!sms[dev & 63]) cudaDeviceGetAttribute(&sms[dev & 63], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev & 63];
}

// CTAs of a persistent grid of `kernel` (kQWarps warps, kQPass scale blocks
// per warp and pass): as many as fit on the card at once (per_sm, asked once
// per instance), no more than `blocks` needs
template <typename K>
static int persistent_ctas(K kernel, int* per_sm, long long blocks) {
  if (!*per_sm) cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kQWarps * 32, 0);
  const long long need = (blocks + kQWarps * kQPass - 1) / (kQWarps * kQPass);
  return (int)max(1LL, min(need, (long long)max(*per_sm, 1) * sm_count()));
}

// B5's codes mode: quantize_kernel for blocks of 128 on aligned pointers,
// quantize_generic_kernel otherwise
template <typename TIn, typename TCode>
static void launch_quantize(const void* x, void* codes, float* scales,
                            long long nblocks, int block, F2PConsts f,
                            const int4* enc, float inv_max, int pow2,
                            cudaStream_t stream) {
  const uint32_t sign_mask = f.is_signed ? 0x80000000u : 0u;
  const bool fast = block == 128 && nblocks < (1LL << 30) &&
                    (uintptr_t)x % (4 * sizeof(TIn)) == 0 &&
                    (uintptr_t)codes % (4 * sizeof(TCode)) == 0;
  if (fast && pow2) {
    static int per_sm = 0;
    auto k = quantize_kernel<TIn, TCode, true>;
    k<<<persistent_ctas(k, &per_sm, nblocks), kQWarps * 32, 0, stream>>>(
        (const TIn*)x, (TCode*)codes, scales, (int)nblocks, enc, sign_mask, 31 - f.nu,
        inv_max);
  } else if (fast) {
    static int per_sm = 0;
    auto k = quantize_kernel<TIn, TCode, false>;
    k<<<persistent_ctas(k, &per_sm, nblocks), kQWarps * 32, 0, stream>>>(
        (const TIn*)x, (TCode*)codes, scales, (int)nblocks, enc, sign_mask, 31 - f.nu,
        inv_max);
  } else {
    const int grid = (int)min((nblocks + 7) / 8, (long long)1 << 20);
    quantize_generic_kernel<TIn, TCode><<<grid, 256, 0, stream>>>(
        (const TIn*)x, (TCode*)codes, scales, nblocks, block, f, inv_max, pow2);
  }
}

template <typename TIn>
static int launch_kv_write(const KVWriteArgs& a, int grid, size_t smem,
                           cudaStream_t stream) {
  auto k = quantize_packed_write_kernel<TIn>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k<<<grid, kKVWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
// B4, dequantize_packed_kernel: packed F2P words [rows, W] uint32 + block
// scales [rows, cols / block] f32 -> values [rows, cols], f32 or bf16, for
// one tensor or for a layer's K and V cache in one launch (blockIdx.y picks
// the side; each side has its own format and table). Replaces
// repro/kernels/f2p_quant.py::_dequant_packed_kernel: unpack the n-bit
// fields, decode, __fmul_rn by the block's scale, __float2bfloat16_rn for
// bf16 out.
//
// What bounds it: bytes. The unfused decode's cache read of one layer
// (8192 rows of 128, 8-bit, bf16 out) moves 1.08 MB in and 2 MB out, 0.95
// us at 3.35 TB/s; K and V twice that. Little more than the card holds in
// flight, so the design keeps a warp's next loads in flight while it
// decodes, keeps the instructions per element few, and spends one launch
// on K and V.
//
// Work unit. Where the rows form one bit stream (cols * n_bits % 32 == 0:
// a row ends on a word, as head_dim 128 does at every width) and a scale
// block holds whole groups of 4 (block % 4 == 0), a warp takes tiles of
// kDQTile = 512 consecutive elements: it loads the tile's 16 n_bits words
// coalesced (16 bytes a lane where the words are 16-byte aligned, else 4)
// into its slice of shared memory, then lane l takes elements 4l..4l+3 of
// each 128, cut from a window of 1-3 words at a fixed bit offset
// (attn_values), one scale per 4 (the same address across the warp at
// block 128: one broadcast load), and stores 8 (bf16) or 16 (f32) bytes.
// The next tile's words and scales are loaded before this one is decoded,
// and the first tile's before the table is built. 32-bit offsets inside a
// tile. Other shapes (rows with slack bits, blocks not a multiple of 4) take
// one warp per row and one element per lane.
//
// Decode: n_bits <= 8 through the table in shared memory that B1/B2 use
// (attn_table: each code's f2p_decode replicated per lane, so a lookup is
// free of bank conflicts; a signed format's table holds the payload codes
// and the sign bit flips the value's), built once per CTA; above 8 bits
// (or where one side of a K+V read is wider) f2p_decode in registers, in
// an instance of its own (TAB = false), so neither pays the other's
// registers. The grid is persistent, kDQPerSM CTAs per SM at most, so the
// table is built a few hundred times. Two per SM, with the registers that
// leaves (66), beat three or four with fewer (56-59) at the serving shape:
// an empty launch takes 1.0 us on the device and the table build 0.2, so
// what is left is the words' round trip, not the SM's issue rate
// (tools/dq_bench.py variants).
// ---------------------------------------------------------------------------
constexpr int kDQWarps = 8;
constexpr int kDQTile = 512;    // elements of a stream-path warp task: 4 x 128
constexpr int kDQPerSM = 2;

struct DQSide {
  const uint32_t* words;
  const float* scales;
  void* out;
  F2PConsts f;
  long long nw;   // words of the side (the stream path)
  int W;          // words per row
  int stream;     // tiles of kDQTile elements, else one warp per row
  int vec;        // stream path: 16-byte loads of the words
  int tasks;      // warp tasks: tiles or rows
  int tab_bits;   // decode table of 2^tab_bits codes; 0: f2p_decode
};

struct DQArgs {
  DQSide side[2];
  long long n;                  // elements of a side: rows * cols
  int cols, block, nblk, lb;    // lb = log2(block) for a power of two, else -1
  int tab_floats, stage;        // shared memory: the table, words per warp
};

// the words of tile t into pre[] (16-byte pieces l, l + 32 or words l,
// l + 32, ...; TAB: n_bits <= 8, at most 128 words) and its 4 scales of
// this lane into sc[]
template <bool TAB>
__device__ __forceinline__ void dq_fetch(const DQArgs& a, const DQSide& s, int t, int lane,
                                         uint32_t (&pre)[TAB ? 4 : 8], float (&sc)[4]) {
  if (t >= s.tasks) return;
  const int tw = (kDQTile / 32) * s.f.n_bits;
  const long long w0 = (long long)t * tw;
  const int n = (int)min((long long)tw, s.nw - w0);
  if (s.vec) {
#pragma unroll
    for (int i = 0; i < (TAB ? 1 : 2); ++i) {
      const int p = lane + 32 * i;
      if (4 * p < n) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(s.words + w0) + p);
        pre[4 * i] = q.x; pre[4 * i + 1] = q.y; pre[4 * i + 2] = q.z; pre[4 * i + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < (TAB ? 4 : 8); ++i)
      if (lane + 32 * i < n) pre[i] = __ldg(s.words + w0 + lane + 32 * i);
  }
  const long long e0 = (long long)t * kDQTile + 4 * lane;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long e = e0 + 128 * c;
    if (e < a.n) sc[c] = __ldg(s.scales + (a.lb >= 0 ? e >> a.lb : e / a.block));
  }
}

__device__ __forceinline__ void dq_store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void dq_store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 u;
  u.x = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[0])) |
        ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[1])) << 16);
  u.y = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2])) |
        ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

// the stream path from tile t on, tile t's words and scales already in
// pre[] / sc[]
template <typename TOut, bool TAB>
__device__ __forceinline__ void dq_stream(const DQArgs& a, const DQSide& s, const float* tab,
                                          uint32_t* stage, int t, int nwarps, int lane,
                                          uint32_t (&pre)[TAB ? 4 : 8], float (&sc)[4]) {
  const int nb = s.f.n_bits, tw = (kDQTile / 32) * nb;
  TOut* out = reinterpret_cast<TOut*>(s.out);
  for (; t < s.tasks; t += nwarps) {
    const long long e0 = (long long)t * kDQTile;
    const int n = (int)min((long long)tw, s.nw - (long long)t * tw);
    if (s.vec) {
#pragma unroll
      for (int i = 0; i < (TAB ? 1 : 2); ++i) {
        const int p = lane + 32 * i;
        if (4 * p < n)
          *reinterpret_cast<uint4*>(stage + 4 * p) =
              make_uint4(pre[4 * i], pre[4 * i + 1], pre[4 * i + 2], pre[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < (TAB ? 4 : 8); ++i)
        if (lane + 32 * i < n) stage[lane + 32 * i] = pre[i];
    }
    float cur[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) cur[c] = sc[c];
    dq_fetch<TAB>(a, s, t + nwarps, lane, pre, sc);   // in flight while this tile decodes
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int off = 128 * c + 4 * lane;
      if (e0 + off < a.n) {
        const int bit = off * nb, sh = bit & 31;
        float v[4];
        attn_values<4, TAB>(stage, bit >> 5, sh, (sh + 4 * nb + 31) >> 5, nb, tab, lane, s.f,
                            cur[c], true, v);
        dq_store4(out + e0 + off, v);
      }
    }
    __syncwarp();
  }
}

// rows that are not one bit stream: one warp per row, one element per lane
template <typename TOut, bool TAB>
__device__ __forceinline__ void dq_rows(const DQArgs& a, const DQSide& s, const float* tab,
                                        int r, int nwarps, int lane) {
  const int nb = s.f.n_bits;
  for (; r < s.tasks; r += nwarps) {
    const uint32_t* row = s.words + (long long)r * s.W;
    const float* sr = s.scales + (long long)r * a.nblk;
    TOut* o = reinterpret_cast<TOut*>(s.out) + (long long)r * a.cols;
    for (int j = lane; j < a.cols; j += 32) {
      const int bit = j * nb, sh = bit & 31;
      float v[1];
      attn_values<1, TAB>(row, bit >> 5, sh, (sh + nb + 31) >> 5, nb, tab, lane, s.f,
                          sr[j / a.block], true, v);
      store(o + j, v[0]);
    }
  }
}

// TAB: every side decodes through its table (n_bits <= 8); else every
// side decodes in registers
template <typename TOut, bool TAB>
__global__ void __launch_bounds__(kDQWarps * 32, kDQPerSM)
dequantize_packed_kernel(const __grid_constant__ DQArgs a) {
  extern __shared__ float4 dq_smem4[];
  const DQSide& s = a.side[blockIdx.y];
  if ((int)blockIdx.x * kDQWarps >= s.tasks) return;   // CTA-uniform
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kDQWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kDQWarps;
  float* tab = reinterpret_cast<float*>(dq_smem4);
  uint32_t* stage = reinterpret_cast<uint32_t*>(tab + a.tab_floats) + (threadIdx.x >> 5) * a.stage;
  uint32_t pre[TAB ? 4 : 8];
  float sc[4];
  if (s.stream) dq_fetch<TAB>(a, s, t, lane, pre, sc);   // in flight while the table is built
  if (TAB) {
    attn_table(tab, s.tab_bits, s.f);
    __syncthreads();
  }
  if (s.stream)
    dq_stream<TOut, TAB>(a, s, tab, stage, t, nwarps, lane, pre, sc);
  else
    dq_rows<TOut, TAB>(a, s, tab, t, nwarps, lane);
}

// the plan of one side (shapes and its words' alignment); false when the
// kernel cannot take it
static bool dq_side(DQArgs& a, DQSide& s, int rows) {
  const int nb = s.f.n_bits;
  if (nb < 1 || nb > 16) return false;
  s.W = (int)(((long long)a.cols * nb + 31) / 32);
  s.stream = (long long)a.cols * nb % 32 == 0 && a.block % 4 == 0;
  s.nw = s.stream ? a.n * nb / 32 : 0;
  s.vec = s.stream && (uintptr_t)s.words % 16 == 0 && s.nw % 4 == 0;
  const long long tasks = s.stream ? (a.n + kDQTile - 1) / kDQTile : rows;
  if (tasks >= (1LL << 31) || (!s.stream && (long long)a.cols * nb >= (1LL << 31)))
    return false;
  s.tasks = (int)tasks;
  s.tab_bits = nb <= 8 ? (s.f.is_signed ? s.f.nu : nb) : 0;
  if (s.tab_bits) a.tab_floats = max(a.tab_floats, 32 << s.tab_bits);
  if (s.stream) a.stage = max(a.stage, (kDQTile / 32) * nb);
  return true;
}

template <typename TOut>
static int launch_dequantize_packed(const DQArgs& a, dim3 grid, size_t smem,
                                    cudaStream_t stream) {
  if (a.tab_floats)
    dequantize_packed_kernel<TOut, true><<<grid, kDQWarps * 32, smem, stream>>>(a);
  else
    dequantize_packed_kernel<TOut, false><<<grid, kDQWarps * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
extern "C" {

#if F2P_IN(4)
const char* f2p_error_string(int rc) { return cudaGetErrorString((cudaError_t)rc); }
#endif

#if F2P_IN(4)
// B3: one launch of quantize_packed_write_kernel. k (and v when nside is
// 2) is [B, S, Kh, cols], f32 or bf16 (x_bf16), at its strides in elements;
// row (b, s, h) goes to row (page * T + off) * Kh + h of its side's words
// [.., W] and scales [.., cols / block], with p = pos[b] + s and page =
// pages[b, min(p / T, maxp - 1)], off = p % T, or, with pages null, page =
// b and off = p. Rows whose destination lies outside [0, P) x [0, T) are
// skipped. A staged side needs kKVWarps x chunk x block codes of shared
// memory per CTA (block 128: 2 KB).
int f2p_kv_write(KVSideIn k, KVSideIn v, int nside, int x_bf16, const int* pages,
                 AttnLen pos, int B, int S, int Kh, int cols, int block, int T,
                 int P, int maxp, int pow2, cudaStream_t stream) {
  if (nside < 1 || nside > 2 || block < 1 || cols % block || T < 1 ||
      (pages && maxp < 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S * Kh;
  if (rows <= 0 || cols <= 0) return 0;
  KVWriteArgs a;
  a.B = B; a.S = S; a.Kh = Kh; a.block = block; a.nblk = cols / block; a.T = T; a.P = P;
  a.maxp = maxp; a.pow2 = pow2; a.pages = pages; a.pos = pos; a.stage = 0;
  const int esize = x_bf16 ? 2 : 4;
  long long tasks[2] = {0, 0};
  for (int i = 0; i < nside; ++i) {
    KVSide& sd = a.side[i];
    sd.in = i ? v : k;
    const int nb = sd.in.f.n_bits;
    if (nb < 1 || nb > 16 || sd.in.W != (int)(((long long)cols * nb + 31) / 32))
      return (int)cudaErrorInvalidValue;
    // the fewest blocks whose bits end on a word: 32 / gcd(block * nb, 32)
    int tz = 0;
    while (tz < 5 && !((((long long)block * nb) >> tz) & 1)) ++tz;
    sd.chunk = min(32 >> tz, a.nblk);
    sd.nchunk = (a.nblk + sd.chunk - 1) / sd.chunk;
    sd.vec = block == 128 && sd.in.sd == 1 &&
             (uintptr_t)sd.in.x % (4 * esize) == 0 && (B == 1 || sd.in.sb % 4 == 0) &&
             (S == 1 || sd.in.ss % 4 == 0) && (Kh == 1 || sd.in.sh % 4 == 0);
    sd.direct = sd.vec && nb == 8;
    if (!sd.direct) a.stage = max(a.stage, sd.chunk * block);
    tasks[i] = rows * sd.nchunk;
  }
  if (nside == 1) a.side[1] = a.side[0];
  if (tasks[0] + tasks[1] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  a.tasks0 = (int)tasks[0];
  a.tasks = (int)(tasks[0] + tasks[1]);
  const size_t smem = (size_t)kKVWarps * a.stage * sizeof(uint32_t);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const int grid = min((a.tasks + kKVWarps - 1) / kKVWarps, 1 << 20);
  if (x_bf16) return launch_kv_write<__nv_bfloat16>(a, grid, smem, stream);
  return launch_kv_write<float>(a, grid, smem, stream);
}
#endif

#if F2P_IN(4)
// B4: one launch of dequantize_packed_kernel. Side k (and v when nside is
// 2, a layer's K and V cache, each in its own format): words [rows, W]
// uint32 (W = ceil(cols * n_bits / 32)) + scales [rows, cols / block] f32
// -> out [rows, cols], f32 or bf16 (out_bf16); every tensor contiguous, the
// outputs 16-byte aligned.
int f2p_dequantize_packed(const uint32_t* kw, const float* ks, void* ko, F2PConsts fk,
                          const uint32_t* vw, const float* vs, void* vo, F2PConsts fv,
                          int nside, int out_bf16, int rows, int cols, int block,
                          cudaStream_t stream) {
  if (nside < 1 || nside > 2 || rows < 0 || cols < 0 || block < 1 || cols % block)
    return (int)cudaErrorInvalidValue;
  if (!rows || !cols) return 0;
  DQArgs a;
  a.n = (long long)rows * cols;
  a.cols = cols; a.block = block; a.nblk = cols / block;
  a.lb = (block & (block - 1)) ? -1 : __builtin_ctz(block);
  a.tab_floats = 0; a.stage = 0;
  a.side[0] = DQSide{kw, ks, ko, fk};
  a.side[1] = DQSide{vw, vs, vo, fv};
  int ctas = 1;
  for (int i = 0; i < nside; ++i) {
    if (!dq_side(a, a.side[i], rows)) return (int)cudaErrorInvalidValue;
    ctas = max(ctas, (a.side[i].tasks + kDQWarps - 1) / kDQWarps);
  }
  if (nside == 1) a.side[1] = a.side[0];
  if (!a.side[0].tab_bits || !a.side[1].tab_bits) a.tab_floats = 0;   // both in registers
  const dim3 grid(min(ctas, max(1, kDQPerSM * sm_count() / nside)), nside);
  const size_t smem = (size_t)(a.tab_floats + kDQWarps * a.stage) * sizeof(float);
  if (out_bf16) return launch_dequantize_packed<__nv_bfloat16>(a, grid, smem, stream);
  return launch_dequantize_packed<float>(a, grid, smem, stream);
}
#endif

#if F2P_IN(4)
// B5, codes mode. tab: the format's encode table (f2p_quant.encode_table:
// 256 int4 entries, then 256 float2 values).
int f2p_quantize(const void* x, int x_bf16, void* codes, int code_bytes,
                 float* scales, long long rows, int cols, int block,
                 F2PConsts f, const void* tab, float inv_max, int pow2,
                 cudaStream_t stream) {
  const long long nblocks = rows * (cols / block);
  if (nblocks <= 0) return 0;
  const int4* enc = (const int4*)tab;
  if (x_bf16 && code_bytes == 1)
    launch_quantize<__nv_bfloat16, uint8_t>(x, codes, scales, nblocks, block, f, enc,
                                            inv_max, pow2, stream);
  else if (x_bf16)
    launch_quantize<__nv_bfloat16, uint16_t>(x, codes, scales, nblocks, block, f, enc,
                                             inv_max, pow2, stream);
  else if (code_bytes == 1)
    launch_quantize<float, uint8_t>(x, codes, scales, nblocks, block, f, enc, inv_max,
                                    pow2, stream);
  else
    launch_quantize<float, uint16_t>(x, codes, scales, nblocks, block, f, enc,
                                     inv_max, pow2, stream);
  return (int)cudaGetLastError();
}
#endif

#if F2P_IN(4)
// B5, round-trip mode: one launch of ef_roundtrip_kernel over the nleaves
// EFLeaf rows at `leaves` (on the device; row nleaves holds blk0 = nblocks),
// blocks of 128, f32 scales; ef: error feedback.
int f2p_ef_roundtrip(const void* leaves, int nleaves, int nblocks, int ef,
                     const void* tab, F2PConsts f, float inv_max,
                     cudaStream_t stream) {
  if (nleaves < 1 || nblocks < 0 || nblocks >= (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (!nblocks) return 0;
  const int4* enc = (const int4*)tab;
  const float2* val = (const float2*)(enc + kEncEntries);
  const uint32_t sign_mask = f.is_signed ? 0x80000000u : 0u;
  if (ef) {
    static int per_sm = 0;
    auto k = ef_roundtrip_kernel<true>;
    k<<<persistent_ctas(k, &per_sm, nblocks), kQWarps * 32, 0, stream>>>(
        (const EFLeaf*)leaves, nleaves, nblocks, enc, val, sign_mask, 31 - f.nu, inv_max);
  } else {
    static int per_sm = 0;
    auto k = ef_roundtrip_kernel<false>;
    k<<<persistent_ctas(k, &per_sm, nblocks), kQWarps * 32, 0, stream>>>(
        (const EFLeaf*)leaves, nleaves, nblocks, enc, val, sign_mask, 31 - f.nu, inv_max);
  }
  return (int)cudaGetLastError();
}
#endif

#if F2P_IN(4)
// The exhaustive check of the table encode over the patterns [start, start +
// count) (encode_check_kernel); bad and first are device counters.
int f2p_encode_check(unsigned start, long long count, const void* tab, F2PConsts f,
                     float s, unsigned long long* bad, unsigned* first,
                     cudaStream_t stream) {
  const int4* enc = (const int4*)tab;
  encode_check_kernel<<<8 * sm_count(), 256, 0, stream>>>(
      start, count, enc, (const float2*)(enc + kEncEntries), f, s, bad, first);
  return (int)cudaGetLastError();
}
#endif

#if F2P_IN(4)
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
#endif

#if F2P_IN(3)
// B1 / B2: one launch of attention_decode_kernel. q [B, Sq, H, hd] (f32
// or bf16 by q_bf16; strides qsb, qss, qsh, dims contiguous) -> out [B, Sq,
// H, hd] contiguous in q's dtype. pages null: dense [B, S, K, W] words;
// else [P, T, K, W] slabs through pages [B, maxp] (S = maxp * T). The plan
// (tile positions per CTA, a multiple of kAttnChunk; nsplit = ceil(S /
// tile); rg = 3 or 4 rows per CTA in ng groups) comes from
// f2p_attention.attention_plan. With nsplit > 1, part holds B *
// K * ng * nsplit * (rg * hd + 2 rg) floats and counts B * K * ng ints,
// zero before the launch and zero again after it.
int f2p_attention(const void* q, int q_bf16, long long qsb, long long qss, long long qsh,
                  const uint32_t* kw, const float* ks, const uint32_t* vw, const float* vs,
                  const int* pages, AttnLen kvlen, AttnLen qoff, void* out, float* part,
                  int* counts, int B, int Sq, int H, int K, int hd, int Wk, int Wv, int S,
                  int T, int P, int maxp, int causal, int nsplit, int tile, int rg,
                  int ng, F2PConsts fk, F2PConsts fv, float scale, cudaStream_t stream) {
  const int D = hd <= 32 ? 1 : hd <= 64 ? 2 : 4;
  if (hd < 1 || hd > 128 || hd % D || fk.n_bits > 16 || fv.n_bits > 16 || tile <= 0 ||
      tile % kAttnChunk || tile > (1 << 20) ||
      nsplit != max(1, (int)(((long long)S + tile - 1) / tile)) || (rg != 3 && rg != 4) ||
      (nsplit > 1 && (!part || !counts)) || (long long)K * ng > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  AttnArgs a;
  a.q = q; a.qsb = qsb; a.qss = qss; a.qsh = qsh;
  a.kw = kw; a.ks = ks; a.vw = vw; a.vs = vs; a.pages = pages;
  a.out = out; a.part = part; a.counts = counts; a.kvlen = kvlen; a.qoff = qoff;
  a.bf16 = q_bf16; a.Sq = Sq; a.H = H; a.K = K; a.G = H / K; a.R = (H / K) * Sq;
  a.hd = hd; a.S = S; a.T = T; a.P = P; a.maxp = maxp; a.causal = causal; a.ng = ng;
  a.tile = tile;
  a.Wk = Wk; a.Wv = Wv;
  a.win_k = attn_window(hd, D, fk.n_bits);
  a.win_v = attn_window(hd, D, fv.n_bits);
  a.vec_k = Wk % 4 == 0 && (uintptr_t)kw % 16 == 0;
  a.vec_v = Wv % 4 == 0 && (uintptr_t)vw % 16 == 0;
  // the table covers the payload codes (the sign is a bit flip)
  a.tab_k = fk.n_bits <= 8 ? (fk.is_signed ? fk.nu : fk.n_bits) : 0;
  a.tab_v = fv.n_bits <= 8 ? (fv.is_signed ? fv.nu : fv.n_bits) : 0;
  const bool share = a.tab_k && a.tab_v && memcmp(&fk, &fv, sizeof(F2PConsts)) == 0;
  const int tk = a.tab_k ? 32 << a.tab_k : 0;
  a.build_v = a.tab_v && !share;
  a.tv_off = share ? 0 : tk;
  a.tables = tk + (a.build_v ? 32 << a.tab_v : 0);
  // +4: a lane's window may run past the last row; with more than one
  // pass a warp's acc waits in a stash after its misc floats
  const int kst = max(kAttnChunk * Wk, rg * hd), vst = kAttnChunk * Wv + 4;
  a.kreg = (kst + 3) & ~3;
  a.vreg = (vst + 3) & ~3;
  a.warp_floats = a.kreg + a.vreg + attn_misc_floats() +
                  (tile > kAttnPass ? (rg * hd + 3) & ~3 : 0);
  a.scale = scale; a.fk = fk; a.fv = fv;
  const int nw = kAttnWarps;
  const size_t smem = sizeof(float) * ((size_t)a.tables + (size_t)nw * a.warp_floats);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const dim3 grid(nsplit, K * ng, B);
  if (D == 1) return launch_attention_rg<1>(rg, a, grid, 32 * nw, smem, stream);
  if (D == 2) return launch_attention_rg<2>(rg, a, grid, 32 * nw, smem, stream);
  return launch_attention_rg<4>(rg, a, grid, 32 * nw, smem, stream);
}
#endif

#if F2P_IN(4)
int f2p_counter_advance(const int* state, const float* budget, int* state_out,
                        float* left, const float* p_lut, const float* run_lut,
                        const float* logq_lut, long long n, int kmax,
                        uint32_t seed, uint32_t sweep0, int sweeps,
                        long long lane_base, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  counter_advance_kernel<<<(unsigned)grid, threads, 0, stream>>>(
      state, budget, state_out, left, p_lut, run_lut, logq_lut, n, kmax, seed,
      sweep0, sweeps, lane_base);
  return (int)cudaGetLastError();
}
#endif

#if F2P_IN(1)
// The tile route (M > 8) of B7 / B8: the plan (mma: the tensor-core
// kernel, else the SIMT one; bm, k_chunk, splits; e_shift) comes from
// f2p_matmul.tile_kernel and mma_plan / matmul_split. With splits > 1, part
// holds splits x M x N floats, added into y in split order.
int f2p_dequant_matmul(const void* x, int x_bf16, const void* w, int code_bytes,
                       int W, const float* scales, float* part, float* y, int M,
                       int N, int K, int block, int mma, int bm, int k_chunk,
                       int splits, int e_shift, F2PConsts f, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (mma) {
    if (block < 16 || (block & (block - 1)) || K % kMmaBK || k_chunk % kMmaBK ||
        k_chunk <= 0 || (bm != 64 && bm != 128) || f.n_bits > 10 || e_shift < -126 ||
        e_shift > 126)
      return (int)cudaErrorInvalidValue;
    MmaArgs a;
    a.x = x; a.scales = scales; a.part = part; a.M = M; a.N = N; a.K = K;
    a.block = block; a.k_chunk = k_chunk; a.bm = bm;
    // table copies: 32 up to 8 bits, 2 above (so that f32 x and uint16
    // codes fit 128 rows)
    a.lut_bits = f.n_bits; a.lrep = f.n_bits <= 8 ? 5 : 1;
    a.e_shift = e_shift;
    a.async_x = (uintptr_t)x % 16 == 0;
    a.async_w = 0;   // set per source by launch_mma
    a.async_s = (uintptr_t)scales % 16 == 0 && N % 4 == 0;
    a.vec_out = (uintptr_t)part % 8 == 0 && N % 2 == 0;
    a.f = f;
    int rc;
    if (code_bytes == 1)
      rc = launch_mma_in(x_bf16, a, UnpackedW<uint8_t>{(const uint8_t*)w, N}, splits, stream);
    else if (code_bytes == 2)
      rc = launch_mma_in(x_bf16, a, UnpackedW<uint16_t>{(const uint16_t*)w, N}, splits,
                         stream);
    else
      rc = launch_mma_in(x_bf16, a, PackedW{(const uint32_t*)w, W, f.n_bits}, splits,
                         stream);
    if (rc) return rc;
  } else if (code_bytes == 1) {
    launch_matmul_in(x_bf16, x, UnpackedW<uint8_t>{(const uint8_t*)w, N}, scales,
                     part, M, N, K, block, bm, k_chunk, splits, f, stream);
  } else if (code_bytes == 2) {
    launch_matmul_in(x_bf16, x, UnpackedW<uint16_t>{(const uint16_t*)w, N},
                     scales, part, M, N, K, block, bm, k_chunk, splits, f, stream);
  } else {
    launch_matmul_in(x_bf16, x, PackedW{(const uint32_t*)w, W, f.n_bits}, scales,
                     part, M, N, K, block, bm, k_chunk, splits, f, stream);
  }
  if (splits > 1) {
    const long long mn = (long long)M * N;
    const int grid = (int)min((mn + 255) / 256, (long long)1 << 16);
    sum_splits_kernel<<<grid, 256, 0, stream>>>(part, y, mn, splits);
  }
  return (int)cudaGetLastError();
}
#endif

#if F2P_IN(2)
// the decode route (M <= 8) of the same function: the plan (k_chunk,
// splits) comes from f2p_matmul.decode_plan; block is a power of two and a
// multiple of kDecUnit. With splits > 1, part holds splits x M x N floats
// and counts one int per column group, zero before the launch and zero
// again after it.
int f2p_dequant_matmul_decode(const void* x, int x_bf16, const void* w,
                              int code_bytes, int W, const float* scales,
                              float* part, float* y, int* counts, int M, int N,
                              int K, int block, int k_chunk, int splits,
                              F2PConsts f, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M > kDecRows) return (int)cudaErrorInvalidValue;
  const int nb = f.n_bits;
  // byte codes: a table of every byte value; packed words: a table up to 8
  // bits; f2p_decode above (and for uint16 codes, which hold more)
  const int lut_bits = code_bytes == 1 ? 8 : code_bytes == 0 && nb <= 8 ? nb : 0;
  int lb = 0;
  while ((1 << lb) < block) ++lb;
  const float* out = splits > 1 ? part : y;
  const int vec = N % 8 == 0 && (uintptr_t)scales % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                  (uintptr_t)y % 16 == 0;
  const long long stride = code_bytes ? (long long)N * code_bytes : 4LL * W;
  const int async = (uintptr_t)w % 16 == 0 && stride % 16 == 0;
  if (code_bytes == 1)
    return launch_decode(x, x_bf16, DecU8{(const uint8_t*)w, N}, scales, part, y, counts,
                         M, N, K, lb, k_chunk, splits, lut_bits, vec, async, f, stream);
  if (code_bytes == 2)
    return launch_decode(x, x_bf16, DecU16{(const uint16_t*)w, N}, scales, part, y, counts,
                         M, N, K, lb, k_chunk, splits, lut_bits, vec, async, f, stream);
  return launch_decode(x, x_bf16, DecPacked{(const uint32_t*)w, W, nb}, scales, part, y,
                       counts, M, N, K, lb, k_chunk, splits, lut_bits, vec, async, f,
                       stream);
}
#endif

#if F2P_IN(4)
int f2p_counter_estimate(const int* state, const float* grid_lut, float* out,
                         long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long grid = (n + threads - 1) / threads;
  counter_estimate_kernel<<<(unsigned)grid, threads, 0, stream>>>(
      state, grid_lut, out, n);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
