// K1: AdaLN-modulated LayerNorm, y = LN(x) * (1 + scale[b]) + shift[b].
// K6: RMSNorm, y = x * rsqrt(mean(x^2) + eps) * w (the UNetT's pre-norms and
// qk-norm's per-head rows).
//
// K1 replaces f5tts_tpu/ops/adaln_norm.py:48 _adaln_norm_kernel, K6 :97
// _rms_norm_kernel. Bound: memory. Each row is read once and written once
// (8.4 MB per call at [2, 1024, 1024] bf16, about 2.5 us at 3.35 TB/s); the
// arithmetic is a few flops per byte.
//
// Both are epilogues of one row engine, `norm_rows_kernel`: L = min(32, d / 8)
// lanes share a row (rounded up to 8, 16 or 32), each with V 16-byte vectors
// of it (V = 1 at d = 64: 4 rows a warp; 3 at d = 768, 4 at 1024: a warp a
// row). The row sums are a segmented shuffle reduction over the row's lanes,
// no shared memory, no barrier (K1's two sums interleaved). A persistent grid
// walks the rows; a thread issues the loads of its R = RN_VEC / V rows before
// it reduces any. Rows of x lie at up to three leading strides, the last
// dimension contiguous (qk-norm's head view of the q / k projection, no
// copy); the output is contiguous. In f32, one rounding:
// - K6 (`RmsEpi`): (x * rstd) * w, w f32 (as the JAX package keeps it) or bf16.
// - K1 (`AdaLNEpi`): the JAX kernel's one-pass statistics, var = max(s2/d -
//   mean^2, 0), then (x - mean) * rstd * (1 + scale[b]) + shift[b]; scale and
//   shift are row views of the [b, 6d] or [b, 2d] modulation. A lane keeps
//   its columns of them in bf16 registers, widened at use (faster than in
//   f32: fewer registers), and reloads them only when a row's batch changes;
//   a thread's grid-stride walk meets b in increasing order, so they cross L2
//   at most b times a thread, not once a row.
// Past V = 4 (d > 1024, no preset) w, scale and shift are read from L2 at use.
//
// K12: the per-row int8 quantize of the int8 W8A8 projections
// (f5tts_tpu_torch/ops/quant.py quantize_rows): amax = max |x| over a row,
// scale = amax / 127 (1 for an all-zero row), codes = clip(round(x / scale),
// -127, 127), round half to even. It has no Pallas counterpart: the JAX
// package leaves f5tts_tpu/ops/quant.py:42 quantize_rows to XLA, which fuses
// the max-reduce into the elementwise chain before it (quant.py:12-14). The
// port does the same where the producer of the rows is a kernel of this
// file or a GELU, in three modes:
// - the quantize stage of the row engine (`Quant<Epi>`, K1Q and K6Q): the
//   norm's y is rounded to bf16 in registers as K1 / K6 would store it, the
//   row's |max| taken over those values with the sums' segmented shuffle,
//   and int8 codes and one f32 scale a row written in place of the bf16 row
//   (4.19 MB in, 2.10 MB out at [2, 1024, 1024]: about 1.9 us at 3.35 TB/s,
//   against 2.5 + 1.9 us for K1 then K12);
// - `quant_rows_kernel<GeluTanhIn>`: PyTorch's tanh-GELU in f32, rounded to
//   bf16, then quantized (ff.out's input: the bf16 GELU tensor is never
//   written);
// - `quant_rows_kernel<RowsIn>`: rows as they lie (to_out's input, and the
//   MMDiT's to_out_c reading the text rows of the joint attention output in
//   place), a sibling of the engine with its lane layout, grid and strided
//   rows. Bound: memory, 2 bytes read and 1 written an element (6.3 MB at
//   [2, 1024, 1024], about 1.9 us).
// The codes equal round-half-even of the IEEE quotient x / scale, as the
// plain version's `x.float() / scale`: multiplying by 127 / amax would move
// values across .5 boundaries. A code is the rounded product with the
// row's correctly rounded reciprocal, branch-free, which lies within 1.2e-5
// of the quotient; only next to a .5 step do IEEE divisions (`__fdiv_rn`)
// decide (`QuantRow`).
#include <type_traits>

#include "common.cuh"

#ifndef RN_VEC
// 16-byte vectors of x a thread loads before it reduces: R = RN_VEC / V rows.
// 2 measured 2% slower at [2, 16, 4096, 64] and 17% faster at [2, 16, 256,
// 64], 8 slower at both (`scripts/kernel_ab.py --define RN_VEC=...`).
#define RN_VEC 4
#endif
// Threads a block: two rows where a row takes a warp (d >= 256), so a grid
// of few rows reaches every SM and the SMs pack finer (K1 6-10% faster than
// at 256, `scripts/kernel_ab.py`); 256 for narrower rows (qk-norm's head
// rows measured 9-11% slower at 64).
template <int L>
__host__ __device__ constexpr int rn_threads() { return L == 32 ? 64 : 256; }
// the engine counts rows in 32-bit unsigned ints, a grid stride past the last
#define RN_MAX_ROWS (2147483647 - 65535)

// Where the rows of x lie: row r = (i0 * n1 + i1) * n2 + i2 starts at element
// i0 * s0 + i1 * s1 + i2 * s2 (every stride a multiple of 8); its d values
// are contiguous. The output row r starts at r * d. K1 is batch i0.
struct RnRows {
    int rows, n1, n2;
    long long s0, s1, s2;
};

// Row `row` of x and its batch index i0.
__device__ __forceinline__ const bf16* rn_row(const bf16* x, const RnRows& p, unsigned row,
                                              unsigned& batch) {
    const unsigned i2 = row % p.n2, t = row / p.n2;
    batch = p.n1 == 1 ? t : t / p.n1;  // K1's rows and merged ones: no division
    return x + batch * p.s0 + (t - batch * p.n1) * p.s1 + i2 * p.s2;
}

// w[i..i+8) as floats, from an f32 or a bf16 weight row
__device__ __forceinline__ void load_w8(const float* w, int i, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(w + i);
    const float4 c = *reinterpret_cast<const float4*>(w + i + 4);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = c.x; f[5] = c.y; f[6] = c.z; f[7] = c.w;
}

__device__ __forceinline__ void load_w8(const bf16* w, int i, float* f) {
    unpack8(*reinterpret_cast<const uint4*>(w + i), f);
}

// ---------------------------------------------------------------------------
// The quantize stage (K12's three modes)
// ---------------------------------------------------------------------------

// max |v| over 8 bf16 values, in bf16 pairs (exact: no rounding)
__device__ __forceinline__ float absmax8(const uint4& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const __nv_bfloat162 m = __hmax2(__hmax2(__habs2(h[0]), __habs2(h[1])),
                                     __hmax2(__habs2(h[2]), __habs2(h[3])));
    return fmaxf(__low2float(m), __high2float(m));
}

// A row's scale and the codes of its values: clip(round_half_even(f /
// scale), -127, 127). The exact product f * inv lies within 1.2e-5 of the
// IEEE quotient's rounding for |f / scale| <= 127 (inv's rounding, 2^-24
// relative, and half an ulp of the quotient); fma(f, inv, 1.5 * 2^23)
// rounds it half to even in its low bits and lies in [2^23, 2^24), so its
// low byte is the code's two's complement. Branch-free for 8 values; where
// one of them lies within 4e-5 of a .5 step (about 1 vector in 1,500 on
// Gaussian rows), or the scale is so small or large that its reciprocal may
// not be exact, the 8 IEEE quotients decide.
struct QuantRow {
    float scale, inv;  // amax / 127 (1 for an all-zero row); its reciprocal, rounded
    bool exact;        // divide every value
    __device__ explicit QuantRow(float amax) {
        scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
        inv = __frcp_rn(scale);
        exact = !(scale >= 0x1p-100f && scale <= 0x1p100f);
    }
    // the codes of 8 bf16 values, as 8 bytes
    __device__ __forceinline__ uint2 codes8(const uint4& v) const {
        constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
        float f[8];
        unpack8(v, f);
        uint32_t c[8];
        float worst = 0.f;  // the largest |f * inv - round(f * inv)|
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float biased = __fmaf_rn(f[e], inv, MAGIC);
            worst = fmaxf(worst, fabsf(__fmaf_rn(f[e], inv, -__fsub_rn(biased, MAGIC))));
            c[e] = __float_as_uint(biased);
        }
        if (exact || worst > 0.49996f) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
                c[e] = (uint32_t)max(-127, min(127, __float2int_rn(__fdiv_rn(f[e], scale))));
        }
        // the low bytes of four codes as one word, code e in byte e
        const auto pack4 = [](const uint32_t* w) {
            return __byte_perm(__byte_perm(w[0], w[1], 0x0040), __byte_perm(w[2], w[3], 0x0040),
                               0x5410);
        };
        return make_uint2(pack4(c), pack4(c + 4));
    }
};

// The rows' maxima reduced over their L lanes, then each row's scale and
// codes: raw[j][v] holds 8 bf16 values of row base + j * slots + slot (0
// past the row), amax[j] the lane's |max| of them.
template <int L, int V, int R>
__device__ __forceinline__ void store_codes(const uint4 (&raw)[R][V], float (&amax)[R],
                                            int8_t* __restrict__ codes,
                                            float* __restrict__ row_scale, unsigned base,
                                            unsigned slots, unsigned slot, unsigned rows,
                                            int lane, int nvec, int d) {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < R; ++j)
            amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], off));
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
        const unsigned row = base + j * slots + slot;
        if (row >= rows) continue;
        const QuantRow q(amax[j]);
        if (lane == 0) row_scale[row] = q.scale;
        int8_t* crow = codes + (size_t)row * d;
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const int vi = lane + v * L;
            if (vi < nvec) *reinterpret_cast<uint2*>(crow + vi * 8) = q.codes8(raw[j][v]);
        }
    }
}

// ---------------------------------------------------------------------------
// The row engine: K1, K6 and their quantize stage (K1Q, K6Q)
// ---------------------------------------------------------------------------

// An epilogue gives: kMean (whether the row's mean is taken), kPerBatch
// (whether its column operands depend on the batch index), Cols (its
// operands for 8 columns), load(cols, batch, i) for columns [i, i + 8) and
// apply(cols, x, mean, rstd, y) for 8 values of a row.
template <typename W>
struct RmsEpi {
    static constexpr bool kMean = false, kPerBatch = false;
    struct Cols { float w[8]; };
    const W* w;
    __device__ void load(Cols& c, unsigned, int i) const { load_w8(w, i, c.w); }
    __device__ static void apply(const Cols& c, const float* f, float, float rstd, float* y) {
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (f[e] * rstd) * c.w[e];
    }
};

struct AdaLNEpi {
    static constexpr bool kMean = true, kPerBatch = true;
    struct Cols { uint4 scale, shift; };  // bf16, widened at use
    const bf16 *scale, *shift;
    long long scale_stride, shift_stride;
    __device__ void load(Cols& c, unsigned batch, int i) const {
        c.scale = *reinterpret_cast<const uint4*>(scale + batch * scale_stride + i);
        c.shift = *reinterpret_cast<const uint4*>(shift + batch * shift_stride + i);
    }
    __device__ static void apply(const Cols& c, const float* f, float mean, float rstd, float* y) {
        float s[8], h[8];
        unpack8(c.scale, s), unpack8(c.shift, h);
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = (f[e] - mean) * rstd * (1.f + s[e]) + h[e];
    }
};

// The quantize stage on an epilogue: the engine writes int8 codes [rows, d]
// and one f32 scale a row in place of the bf16 rows (its `out` unused).
template <class Epi>
struct Quant : Epi {
    int8_t* codes;
    float* row_scale;
};
template <class Epi>
struct is_quant : std::false_type {};
template <class Epi>
struct is_quant<Quant<Epi>> : std::true_type {};

template <class Epi, int L, int V, int R>
__global__ void __launch_bounds__(rn_threads<L>()) norm_rows_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ out, const RnRows p, int d, float eps,
    const Epi epi) {
    constexpr unsigned SLOTS = rn_threads<L>() / L;  // rows a block holds at once
    constexpr bool REGS = V <= 4;  // the epilogue's columns stay in registers
    constexpr bool QUANT = is_quant<Epi>::value;
    const int lane = threadIdx.x % L;
    const unsigned slot = threadIdx.x / L, rows = p.rows;
    const int nvec = d / 8;
    typename Epi::Cols cols[REGS ? V : 1];
    unsigned cols_batch = ~0u;  // the batch index `cols` holds (none yet)
    auto hold = [&](unsigned batch) {  // `cols` of that batch, loaded if new
        if constexpr (REGS) {
            if (batch != cols_batch) {
#pragma unroll
                for (int v = 0; v < V; ++v)
                    if (lane + v * L < nvec) epi.load(cols[v], batch, (lane + v * L) * 8);
            }
        }
        cols_batch = batch;
    };
    if constexpr (!Epi::kPerBatch) hold(0);
    for (unsigned base = blockIdx.x * SLOTS * R; base < rows; base += gridDim.x * SLOTS * R) {
        uint4 raw[R][V];
        unsigned batch[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const unsigned row = base + j * SLOTS + slot;
            const bf16* xr = rn_row(x, p, row, batch[j]);
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const int vi = lane + v * L;
                raw[j][v] = row < rows && vi < nvec
                                ? *reinterpret_cast<const uint4*>(xr + vi * 8)
                                : make_uint4(0, 0, 0, 0);
            }
        }
        if (Epi::kPerBatch && base + slot < rows) hold(batch[0]);  // in flight beside x
        float s1[R], s2[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            // A partial sums, not one chain of 8V adds (more than 4 spill at V = 8)
            constexpr int A = V < 4 ? V : 4;
            float a1[A] = {}, a2[A] = {};
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float f[8];
                unpack8(raw[j][v], f);
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    if constexpr (Epi::kMean) a1[v % A] += f[e];
                    a2[v % A] += f[e] * f[e];
                }
            }
            s1[j] = a1[0], s2[j] = a2[0];
#pragma unroll
            for (int v = 1; v < A; ++v) s1[j] += a1[v], s2[j] += a2[v];
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < R; ++j) {
                if constexpr (Epi::kMean) s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
                s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
            }
        }
        float amax[R];  // the quantize stage: a lane's |max| of its bf16 outputs
#pragma unroll
        for (int j = 0; j < R; ++j) {
            amax[j] = 0.f;
            const unsigned row = base + j * SLOTS + slot;
            if (row >= rows) continue;
            const float mean = Epi::kMean ? s1[j] / d : 0.f;
            const float var = Epi::kMean ? fmaxf(s2[j] / d - mean * mean, 0.f) : s2[j] / d;
            const float rstd = rsqrtf(var + eps);
            if (Epi::kPerBatch) hold(batch[j]);  // a batch boundary among a thread's rows
            bf16* orow = out + (size_t)row * d;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const int vi = lane + v * L;
                if (vi >= nvec) continue;
                float f[8], y[8];
                unpack8(raw[j][v], f);
                typename Epi::Cols c;
                if constexpr (REGS) c = cols[v]; else epi.load(c, batch[j], vi * 8);
                Epi::apply(c, f, mean, rstd, y);
                const uint4 yb = pack8(y);
                if constexpr (QUANT) {  // y as K1 / K6 would store it, kept for the codes
                    raw[j][v] = yb;
                    amax[j] = fmaxf(amax[j], absmax8(yb));
                } else {
                    *reinterpret_cast<uint4*>(orow + vi * 8) = yb;
                }
            }
        }
        if constexpr (QUANT)
            store_codes<L, V, R>(raw, amax, epi.codes, epi.row_scale, base, SLOTS, slot, rows,
                                 lane, nvec, d);
    }
}

// A persistent grid: no more blocks than the card holds at once, nor than
// the rows need.
template <class Epi, int L, int V>
static int launch_norm_rows(const bf16* x, bf16* out, const RnRows& p, int d, float eps,
                            const Epi& epi, cudaStream_t stream) {
    constexpr int R = V >= RN_VEC ? 1 : RN_VEC / V;
    constexpr int THREADS = rn_threads<L>(), ROWS_A_BLOCK = THREADS / L * R;
    auto kernel = norm_rows_kernel<Epi, L, V, R>;
    // the blocks a card holds at once, asked once a device (host time counts:
    // a generate launches K1 or K6 up to 1408 times each)
    int most = 0;
    const cudaError_t err = resident_blocks((const void*)kernel, THREADS, 0, &most);
    if (err != cudaSuccess) return (int)err;
    const int need = (p.rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
    const int blocks = min(need, most);
    kernel<<<blocks, THREADS, 0, stream>>>(x, out, p, d, eps, epi);
    return (int)cudaGetLastError();
}

// The lane layout (L, V) of a row of d values: `launch(L, V)` with both as
// std::integral_constant, after the checks every kernel of the engine needs.
template <class Launch>
static int rn_dispatch(const RnRows& p, int d, Launch&& launch) {
    using std::integral_constant;
    if (d <= 0 || d % 8 || d > 4096) return (int)cudaErrorInvalidValue;
    if (p.rows <= 0) return (int)cudaGetLastError();
    if (p.rows > RN_MAX_ROWS || p.n1 <= 0 || p.n2 <= 0) return (int)cudaErrorInvalidValue;
    const int nvec = d / 8;
    if (nvec <= 8) return launch(integral_constant<int, 8>(), integral_constant<int, 1>());
    if (nvec <= 16) return launch(integral_constant<int, 16>(), integral_constant<int, 1>());
    if (nvec <= 32) return launch(integral_constant<int, 32>(), integral_constant<int, 1>());
    if (nvec <= 64) return launch(integral_constant<int, 32>(), integral_constant<int, 2>());
    if (nvec <= 128) return launch(integral_constant<int, 32>(), integral_constant<int, 4>());
    if (nvec <= 256) return launch(integral_constant<int, 32>(), integral_constant<int, 8>());
    return launch(integral_constant<int, 32>(), integral_constant<int, 16>());
}

template <class Epi>
static int dispatch_norm_rows(const bf16* x, bf16* out, const RnRows& p, int d, float eps,
                              const Epi& epi, cudaStream_t s) {
    return rn_dispatch(p, d, [&](auto l, auto v) {
        return launch_norm_rows<Epi, decltype(l)::value, decltype(v)::value>(x, out, p, d, eps,
                                                                              epi, s);
    });
}

// ---------------------------------------------------------------------------
// K12: rows as they lie, or through a GELU
// ---------------------------------------------------------------------------

// What K12 quantizes: the rows themselves, or PyTorch's tanh-GELU of them
// (at::native GeluCUDAKernelImpl's formula in f32, the same constants and
// order) rounded to bf16, as `F.gelu(x, approximate="tanh")` stores it.
struct RowsIn {
    __device__ static uint4 apply(const uint4& v) { return v; }
};
struct GeluTanhIn {
    __device__ static uint4 apply(const uint4& v) {
        constexpr float kBeta = (float)(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
        constexpr float kKappa = 0.044715f;
        float f[8];
        unpack8(v, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const float x = f[e], x_cube = x * x * x;
            const float inner = kBeta * (x + kKappa * x_cube);
            f[e] = 0.5f * x * (1.f + tanhf(inner));
        }
        return pack8(f);
    }
};

template <class In, int L, int V, int R>
__global__ void __launch_bounds__(rn_threads<L>()) quant_rows_kernel(
    const bf16* __restrict__ x, int8_t* __restrict__ codes, float* __restrict__ row_scale,
    const RnRows p, int d) {
    constexpr unsigned SLOTS = rn_threads<L>() / L;
    const int lane = threadIdx.x % L;
    const unsigned slot = threadIdx.x / L, rows = p.rows;
    const int nvec = d / 8;
    for (unsigned base = blockIdx.x * SLOTS * R; base < rows; base += gridDim.x * SLOTS * R) {
        uint4 raw[R][V];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            const unsigned row = base + j * SLOTS + slot;
            unsigned batch;
            const bf16* xr = rn_row(x, p, row, batch);
#pragma unroll
            for (int v = 0; v < V; ++v) {
                const int vi = lane + v * L;
                raw[j][v] = row < rows && vi < nvec
                                ? *reinterpret_cast<const uint4*>(xr + vi * 8)
                                : make_uint4(0, 0, 0, 0);
            }
        }
        float amax[R];
#pragma unroll
        for (int j = 0; j < R; ++j) {
            amax[j] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                raw[j][v] = In::apply(raw[j][v]);  // GELU(0) = 0: the padding stays 0
                amax[j] = fmaxf(amax[j], absmax8(raw[j][v]));
            }
        }
        store_codes<L, V, R>(raw, amax, codes, row_scale, base, SLOTS, slot, rows, lane, nvec, d);
    }
}

template <class In, int L, int V>
static int launch_quant_rows(const bf16* x, int8_t* codes, float* row_scale, const RnRows& p,
                             int d, cudaStream_t stream) {
    constexpr int R = V >= RN_VEC ? 1 : RN_VEC / V;
    constexpr int THREADS = rn_threads<L>(), ROWS_A_BLOCK = THREADS / L * R;
    auto kernel = quant_rows_kernel<In, L, V, R>;
    int most = 0;
    const cudaError_t err = resident_blocks((const void*)kernel, THREADS, 0, &most);
    if (err != cudaSuccess) return (int)err;
    const int blocks = min((p.rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK, most);
    kernel<<<blocks, THREADS, 0, stream>>>(x, codes, row_scale, p, d);
    return (int)cudaGetLastError();
}

template <class In>
static int dispatch_quant_rows(const void* x, void* codes, void* row_scale, const RnRows& p,
                               int d, void* stream) {
    return rn_dispatch(p, d, [&](auto l, auto v) {
        return launch_quant_rows<In, decltype(l)::value, decltype(v)::value>(
            (const bf16*)x, (int8_t*)codes, (float*)row_scale, p, d, (cudaStream_t)stream);
    });
}

// x: contiguous [b, n, d]; scale / shift: [b, d] rows at scale_stride /
// shift_stride elements (multiples of 8); out: contiguous [b, n, d].
// d % 8 == 0, d <= 4096.
extern "C" int f5_adaln_norm_bf16(const void* x, const void* scale, const void* shift,
                                  void* out, int b, int n, int d,
                                  long long scale_stride, long long shift_stride,
                                  float eps, void* stream) {
    const long long rows = (long long)b * n;
    if (rows > RN_MAX_ROWS) return (int)cudaErrorInvalidValue;
    // row r = i0 * n + i2: batch i0
    const RnRows p{(int)rows, 1, n, (long long)n * d, 0, d};
    const AdaLNEpi epi{(const bf16*)scale, (const bf16*)shift, scale_stride, shift_stride};
    return dispatch_norm_rows((const bf16*)x, (bf16*)out, p, d, eps, epi, (cudaStream_t)stream);
}

// x: rows = n0 * n1 * n2 rows of d contiguous bf16 values at the strides
// s0, s1, s2 (elements); out: contiguous [rows, d]. d % 8 == 0, d <= 4096.
extern "C" int f5_rms_norm_bf16(const void* x, const void* w, int w_is_f32, void* out, int rows,
                                int n1, int n2, long long s0, long long s1, long long s2, int d,
                                float eps, void* stream) {
    const RnRows p{rows, n1, n2, s0, s1, s2};
    cudaStream_t s = (cudaStream_t)stream;
    if (w_is_f32)
        return dispatch_norm_rows((const bf16*)x, (bf16*)out, p, d, eps,
                                  RmsEpi<float>{(const float*)w}, s);
    return dispatch_norm_rows((const bf16*)x, (bf16*)out, p, d, eps,
                              RmsEpi<bf16>{(const bf16*)w}, s);
}

// x: rows = n0 * n1 * n2 rows of d contiguous bf16 values at the strides s0,
// s1, s2 (elements, multiples of 8); codes: contiguous [rows, d] int8;
// row_scale: [rows] f32. d % 8 == 0, d <= 4096.
extern "C" int f5_quant_rows_bf16(const void* x, void* codes, void* row_scale, int rows, int n1,
                                  int n2, long long s0, long long s1, long long s2, int d,
                                  void* stream) {
    return dispatch_quant_rows<RowsIn>(x, codes, row_scale, {rows, n1, n2, s0, s1, s2}, d,
                                       stream);
}

// As f5_quant_rows_bf16, of GELU-tanh(x) rounded to bf16.
extern "C" int f5_gelu_quant_rows_bf16(const void* x, void* codes, void* row_scale, int rows,
                                       int n1, int n2, long long s0, long long s1, long long s2,
                                       int d, void* stream) {
    return dispatch_quant_rows<GeluTanhIn>(x, codes, row_scale, {rows, n1, n2, s0, s1, s2}, d,
                                           stream);
}

// f5_adaln_norm_bf16's rows quantized: codes contiguous [b, n, d] int8,
// row_scale [b * n] f32.
extern "C" int f5_adaln_norm_quant_bf16(const void* x, const void* scale, const void* shift,
                                        void* codes, void* row_scale, int b, int n, int d,
                                        long long scale_stride, long long shift_stride,
                                        float eps, void* stream) {
    const long long rows = (long long)b * n;
    if (rows > RN_MAX_ROWS) return (int)cudaErrorInvalidValue;
    const RnRows p{(int)rows, 1, n, (long long)n * d, 0, d};
    const Quant<AdaLNEpi> epi{{(const bf16*)scale, (const bf16*)shift, scale_stride, shift_stride},
                              (int8_t*)codes, (float*)row_scale};
    return dispatch_norm_rows((const bf16*)x, nullptr, p, d, eps, epi, (cudaStream_t)stream);
}

// f5_rms_norm_bf16's rows quantized: codes contiguous [rows, d] int8,
// row_scale [rows] f32.
extern "C" int f5_rms_norm_quant_bf16(const void* x, const void* w, int w_is_f32, void* codes,
                                      void* row_scale, int rows, int n1, int n2, long long s0,
                                      long long s1, long long s2, int d, float eps, void* stream) {
    const RnRows p{rows, n1, n2, s0, s1, s2};
    cudaStream_t s = (cudaStream_t)stream;
    if (w_is_f32)
        return dispatch_norm_rows((const bf16*)x, nullptr, p, d, eps,
                                  Quant<RmsEpi<float>>{{(const float*)w}, (int8_t*)codes,
                                                       (float*)row_scale},
                                  s);
    return dispatch_norm_rows((const bf16*)x, nullptr, p, d, eps,
                              Quant<RmsEpi<bf16>>{{(const bf16*)w}, (int8_t*)codes,
                                                  (float*)row_scale},
                              s);
}
