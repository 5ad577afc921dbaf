// Forward attention kernels K3, K5, K7 (and the lse modes of K3, K5 and K7) and
// K11: one tile loop, seven entry points.
//
// K3 fused_qkv_rope_attn_kernel: fused QKV + interleaved RoPE + length-masked
//    attention, flat layout. Replaces f5tts_tpu/ops/attention.py:567
//    _fused_qkv_attn_kernel and its streaming twin :659
//    _fused_qkv_attn_kernel_stream with ONE kernel: the online softmax over
//    64-key tiles covers every n, so there is no single-pass/streaming split
//    and no VMEM-driven dispatch threshold.
//    In:  qkv [b, n, 3*h*64] bf16 (the fused to_qkv projection output),
//         cos/sin [>=n, h*64] bf16 flat tables, lengths [b] int32.
//    Out: [b, n, h*64] bf16; rows >= lengths[b] are written as zeros.
// K5 fused_qkv_rope_attn_bias_kernel: the same under an arbitrary key mask.
//    Replaces :1240 _fused_qkv_attn_bias_kernel and :1307 its streaming twin
//    (MMDiT joint attention: audio padding leaves dead keys in the MIDDLE of
//    the joint audio+text sequence, so no prefix length can express it).
//    In:  qkv and joint cos/sin as K3 (audio rows rotate with audio
//         positions, text rows with text positions), kmask [b, n] bool.
//    Out: [b, n, h*64] bf16, every row computed (the caller masks dead rows
//         after to_out); a 64-key tile whose keys are all dead is skipped.
// K7 flash_attn_kernel: head-layout prefix-length attention forward.
//    Replaces :123 _flash_kernel_single and :50 _flash_kernel (the Pallas
//    n <= 2048 / online-softmax split is a VMEM artefact; one loop here).
//    In:  q, k, v [b, h, n, 64] bf16 (already roped), lengths [b] int32.
//    Out: [b, h, n, 64] bf16; q tiles wholly past the length are zeros, rows
//         past the length inside a live tile are computed, as in Pallas.
//    flash_attn_lse_kernel, the training mode (the Pallas bodies with their
//    lse_ref, :115-120 and :161-164, behind :193 _flash_forward(return_lse)):
//    also writes lse [b, h, n] f32 = m + log(l) over the scaled scores, and
//    -1e30 for the rows of q tiles wholly past the length, for the backward
//    K9 (csrc/attention_bwd.cu).
//    fused_qkv_rope_attn_lse_kernel / fused_qkv_rope_attn_bias_lse_kernel:
//    K3 and K5 in the same LSE mode under grad, for their backwards K4 / K8.
//    The lse is of the scores of K3's pre-scaled bf16 q; the scale 1/8 is a
//    power of two, so that q equals the backward's unscaled roped q times the
//    scale exactly, and the lse is the statistic of the backward's scores.
// K11 masked_flash_attn_kernel: head-layout attention under an arbitrary key
//    mask. Replaces :1653 _flash_kernel_bias (behind :1706
//    masked_flash_attention): MMDiT joint attention when the flat K5 cannot
//    take it (qk-norm, whose per-head RMSNorm comes before RoPE, or unfused
//    projections). K7's head layout in K5's key-mask mode.
//    In:  q, k, v [b, h, n, 64] bf16 (already normed and roped), kmask [b, n]
//         bool. Out: [b, h, n, 64] bf16, every row computed. A batch row with
//         no live key gets zeros (l == 0); the JAX reference gives the
//         uniform mean of v there. No model path makes such a row: the
//         audio's first frame is always live.
//
// Bound: tensor-core operations. 4*b*h*n*live_keys*64 flops (8.6 GFLOP at
// b=2, n=1024, h=16, ~9 us at 989 TFLOP/s) against ~12 MB of bytes. Design:
// one 128-thread block per (64-row q tile, head, batch). Q is (roped in f32,)
// scaled by 1/sqrt(d) and kept as bf16 mma.sync A fragments in registers. The
// loop over 64-key tiles stops at the length (bucket padding costs no
// compute) or, under a key mask, skips all-dead tiles: each tile's K is
// (roped on load and) stored into shared memory, V is stored transposed so
// the P@V B fragments are single 32-bit shared loads; scores and the running
// (max, sum, acc) stay in f32 registers. Dead keys get an additive -1e30 (not
// -inf, which makes dead rows NaN) and l == 0 is guarded as the JAX kernels
// guard it. Loads are synchronous; wgmma, TMA and a cp.async pipeline are
// later work. The modes are compile-time template arguments of one body, so
// K3's instantiation is the loop it always was.
#include "common.cuh"

#define AT_D 64
#define AT_BQ 64
#define AT_BK 64
#define AT_LDS 72  // padded shared row (bf16): conflict-free fragment loads
#define AT_NEG -1e30f

// ROPE: rotate q and k with the flat tables. BIAS: key mask row instead of a
// prefix length. ZERO_DEAD_ROWS: write rows >= len as zeros (K3). LSE: write
// each row's lse to lseb (K7's training mode).
// qb/kb/vb/outb point at row 0 of this (batch, head); rows are in_row /
// out_row elements apart; cos_t/sin_t at this head's lanes, tab_row apart;
// lseb at this (batch, head)'s n rows.
template <bool ROPE, bool BIAS, bool ZERO_DEAD_ROWS, bool LSE = false>
__device__ __forceinline__ void attn_fwd_tile(
    const bf16* __restrict__ qb, const bf16* __restrict__ kb, const bf16* __restrict__ vb,
    long long in_row, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    int tab_row, int len, const uint8_t* __restrict__ kmask, bf16* __restrict__ outb,
    long long out_row, int n, float sm_scale, float* __restrict__ lseb = nullptr) {
    const int q0 = blockIdx.x * AT_BQ;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    if (!BIAS && q0 >= len) {  // whole q tile past the length: zeros
        for (int i = tid; i < AT_BQ * 8; i += 128) {
            const int row = q0 + (i >> 3);
            if (row < n)
                *reinterpret_cast<uint4*>(outb + row * out_row + (i & 7) * 8) =
                    make_uint4(0, 0, 0, 0);
        }
        if (LSE && tid < AT_BQ && q0 + tid < n) lseb[q0 + tid] = AT_NEG;
        return;
    }

    __shared__ __align__(16) bf16 sQ[AT_BQ * AT_LDS];
    __shared__ __align__(16) bf16 sK[AT_BK * AT_LDS];
    __shared__ __align__(16) bf16 sVt[AT_D * AT_LDS];  // V transposed: [dim][key]
    __shared__ float sBias[AT_BK];                       // BIAS: this tile's key bias

    // q tile: (rope in f32,) * 1/sqrt(d), round to bf16
    for (int i = tid; i < AT_BQ * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = q0 + r;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < n) {
            unpack8(*reinterpret_cast<const uint4*>(qb + row * in_row + c), f);
            if constexpr (ROPE) {
                float cs[8], sn[8];
                unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)row * tab_row + c), cs);
                unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)row * tab_row + c), sn);
                rope8(f, cs, sn);
            }
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] *= sm_scale;
        }
        *reinterpret_cast<uint4*>(sQ + r * AT_LDS + c) = pack8(f);
    }
    __syncthreads();

    uint32_t qa[4][4];
    {
        const bf16* q_lo = sQ + (warp * 16 + g) * AT_LDS + t4 * 2;
        const bf16* q_hi = q_lo + 8 * AT_LDS;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            qa[kk][0] = lds32(q_lo + kk * 16);
            qa[kk][1] = lds32(q_hi + kk * 16);
            qa[kk][2] = lds32(q_lo + kk * 16 + 8);
            qa[kk][3] = lds32(q_hi + kk * 16 + 8);
        }
    }

    float m_run[2] = {AT_NEG, AT_NEG};
    float l_run[2] = {0.f, 0.f};
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    const int n_tiles = (len + AT_BK - 1) / AT_BK;
    for (int kt = 0; kt < n_tiles; ++kt) {
        const int k0 = kt * AT_BK;
        if constexpr (BIAS) {
            const int key = k0 + tid;
            const bool live = tid < AT_BK && key < n && kmask[key];
            // the barrier also ends the previous tile's shared reads; a tile
            // whose keys are all dead contributes nothing and is skipped
            if (!__syncthreads_or(live)) continue;
            if (tid < AT_BK) sBias[tid] = live ? 0.f : AT_NEG;
        } else {
            __syncthreads();  // previous tile's sK / sVt reads are done
        }
        // K tile (roped on load)
        for (int i = tid; i < AT_BK * 8; i += 128) {
            const int r = i >> 3, c = (i & 7) * 8;
            const int key = k0 + r;
            float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (key < n) {
                unpack8(*reinterpret_cast<const uint4*>(kb + key * in_row + c), f);
                if constexpr (ROPE) {
                    float cs[8], sn[8];
                    unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)key * tab_row + c), cs);
                    unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)key * tab_row + c), sn);
                    rope8(f, cs, sn);
                }
            }
            *reinterpret_cast<uint4*>(sK + r * AT_LDS + c) = pack8(f);
        }
        // V tile, transposed: lane = dim pair, each thread 8 consecutive keys
        for (int i = tid; i < 32 * (AT_BK / 8); i += 128) {
            const int dp = i & 31, kg = (i >> 5) * 8;
            uint32_t w[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int key = k0 + kg + j;
                w[j] = key < n ? *reinterpret_cast<const uint32_t*>(vb + key * in_row + dp * 2)
                               : 0u;
            }
            uint4 lo, hi;  // dim 2dp gets the low halves, dim 2dp+1 the high
            uint32_t* plo = reinterpret_cast<uint32_t*>(&lo);
            uint32_t* phi = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                plo[j] = (w[2 * j] & 0xffffu) | (w[2 * j + 1] << 16);
                phi[j] = (w[2 * j] >> 16) | (w[2 * j + 1] & 0xffff0000u);
            }
            *reinterpret_cast<uint4*>(sVt + (2 * dp) * AT_LDS + kg) = lo;
            *reinterpret_cast<uint4*>(sVt + (2 * dp + 1) * AT_LDS + kg) = hi;
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys
        float s[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            const bf16* kr = sK + (nt * 8 + g) * AT_LDS + t4 * 2;
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                mma_16816(s[nt], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
        }

        // key mask + online softmax (rows g and g+8 of the warp's 16)
        float mx[2] = {AT_NEG, AT_NEG};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            if constexpr (BIAS) {
                const float b0 = sBias[nt * 8 + t4 * 2], b1 = sBias[nt * 8 + t4 * 2 + 1];
                s[nt][0] += b0; s[nt][2] += b0;
                s[nt][1] += b1; s[nt][3] += b1;
            } else {
                const int key = k0 + nt * 8 + t4 * 2;
                if (key >= len) { s[nt][0] += AT_NEG; s[nt][2] += AT_NEG; }
                if (key + 1 >= len) { s[nt][1] += AT_NEG; s[nt][3] += AT_NEG; }
            }
            mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            alpha[r] = __expf(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            s[nt][0] = __expf(s[nt][0] - m_run[0]);
            s[nt][1] = __expf(s[nt][1] - m_run[0]);
            s[nt][2] = __expf(s[nt][2] - m_run[1]);
            s[nt][3] = __expf(s[nt][3] - m_run[1]);
            l_run[0] += s[nt][0] + s[nt][1];
            l_run[1] += s[nt][2] + s[nt][3];
            acc[nt][0] *= alpha[0];
            acc[nt][1] *= alpha[0];
            acc[nt][2] *= alpha[1];
            acc[nt][3] *= alpha[1];
        }

        // acc += P V: P re-packed from the score fragments as bf16 A operands
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            uint32_t pa[4];
            pa[0] = pack_bf16x2(s[2 * kc][0], s[2 * kc][1]);
            pa[1] = pack_bf16x2(s[2 * kc][2], s[2 * kc][3]);
            pa[2] = pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
            pa[3] = pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
            for (int dt = 0; dt < 8; ++dt) {
                const bf16* vr = sVt + (dt * 8 + g) * AT_LDS + kc * 16 + t4 * 2;
                mma_16816(acc[dt], pa, lds32(vr), lds32(vr + 8));
            }
        }
    }

    // finish: quad-reduce l, normalise, (zero rows past the length)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + warp * 16 + g + r * 8;
        if (row >= n) continue;
        const bool live_row = !ZERO_DEAD_ROWS || row < len;
        const float inv = (live_row && l_run[r] != 0.f) ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0) lseb[row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : AT_NEG;
        bf16* orow = outb + row * out_row + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt)
            *reinterpret_cast<uint32_t*>(orow + dt * 8) =
                pack_bf16x2(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
}

__global__ void __launch_bounds__(128) fused_qkv_rope_attn_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t,
    const bf16* __restrict__ sin_t, const int* __restrict__ lengths,
    bf16* __restrict__ out, int n, int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * AT_D;
    const long long row3 = 3LL * hd;
    const bf16* qb = qkv + (size_t)b * n * row3 + h * AT_D;
    attn_fwd_tile<true, false, true>(qb, qb + hd, qb + 2 * hd, row3, cos_t + h * AT_D,
                                     sin_t + h * AT_D, hd, min(max(lengths[b], 0), n), nullptr,
                                     out + (size_t)b * n * hd + h * AT_D, hd, n, sm_scale);
}

__global__ void __launch_bounds__(128) fused_qkv_rope_attn_bias_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t,
    const bf16* __restrict__ sin_t, const uint8_t* __restrict__ kmask,
    bf16* __restrict__ out, int n, int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * AT_D;
    const long long row3 = 3LL * hd;
    const bf16* qb = qkv + (size_t)b * n * row3 + h * AT_D;
    attn_fwd_tile<true, true, false>(qb, qb + hd, qb + 2 * hd, row3, cos_t + h * AT_D,
                                     sin_t + h * AT_D, hd, n, kmask + (size_t)b * n,
                                     out + (size_t)b * n * hd + h * AT_D, hd, n, sm_scale);
}

// K3 and K5 under grad: the same loops in their LSE mode (the training
// forward saves the row lse for the backward K4 / K8).
__global__ void __launch_bounds__(128) fused_qkv_rope_attn_lse_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t,
    const bf16* __restrict__ sin_t, const int* __restrict__ lengths,
    bf16* __restrict__ out, float* __restrict__ lse, int n, int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * AT_D;
    const long long row3 = 3LL * hd;
    const bf16* qb = qkv + (size_t)b * n * row3 + h * AT_D;
    attn_fwd_tile<true, false, true, true>(qb, qb + hd, qb + 2 * hd, row3, cos_t + h * AT_D,
                                           sin_t + h * AT_D, hd, min(max(lengths[b], 0), n),
                                           nullptr, out + (size_t)b * n * hd + h * AT_D, hd, n,
                                           sm_scale, lse + ((size_t)b * heads + h) * n);
}

__global__ void __launch_bounds__(128) fused_qkv_rope_attn_bias_lse_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t,
    const bf16* __restrict__ sin_t, const uint8_t* __restrict__ kmask,
    bf16* __restrict__ out, float* __restrict__ lse, int n, int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * AT_D;
    const long long row3 = 3LL * hd;
    const bf16* qb = qkv + (size_t)b * n * row3 + h * AT_D;
    attn_fwd_tile<true, true, false, true>(qb, qb + hd, qb + 2 * hd, row3, cos_t + h * AT_D,
                                           sin_t + h * AT_D, hd, n, kmask + (size_t)b * n,
                                           out + (size_t)b * n * hd + h * AT_D, hd, n, sm_scale,
                                           lse + ((size_t)b * heads + h) * n);
}

__global__ void __launch_bounds__(128) flash_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, int n, int heads,
    float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t base = ((size_t)b * heads + h) * n * AT_D;
    attn_fwd_tile<false, false, false>(q + base, k + base, v + base, AT_D, nullptr, nullptr, 0,
                                       min(max(lengths[b], 0), n), nullptr, out + base, AT_D, n,
                                       sm_scale);
}

__global__ void __launch_bounds__(128) flash_attn_lse_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lengths, bf16* __restrict__ out, float* __restrict__ lse, int n,
    int heads, float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t rows = ((size_t)b * heads + h) * n;
    attn_fwd_tile<false, false, false, true>(q + rows * AT_D, k + rows * AT_D, v + rows * AT_D,
                                             AT_D, nullptr, nullptr, 0,
                                             min(max(lengths[b], 0), n), nullptr,
                                             out + rows * AT_D, AT_D, n, sm_scale, lse + rows);
}

__global__ void __launch_bounds__(128) masked_flash_attn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ kmask, bf16* __restrict__ out, int n, int heads,
    float sm_scale) {
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t base = ((size_t)b * heads + h) * n * AT_D;
    attn_fwd_tile<false, true, false>(q + base, k + base, v + base, AT_D, nullptr, nullptr, 0, n,
                                      kmask + (size_t)b * n, out + base, AT_D, n, sm_scale);
}

extern "C" int f5_fused_qkv_rope_attn_bf16(const void* qkv, const void* cos_t,
                                           const void* sin_t, const void* lengths,
                                           void* out, int b, int n, int heads,
                                           float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        fused_qkv_rope_attn_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t,
            (const int*)lengths, (bf16*)out, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_bias_bf16(const void* qkv, const void* cos_t,
                                                const void* sin_t, const void* kmask,
                                                void* out, int b, int n, int heads,
                                                float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        fused_qkv_rope_attn_bias_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t,
            (const uint8_t*)kmask, (bf16*)out, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_lse_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               void* out, void* lse, int b, int n, int heads,
                                               float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        fused_qkv_rope_attn_lse_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const int*)lengths,
            (bf16*)out, (float*)lse, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_bias_lse_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    void* out, void* lse, int b, int n,
                                                    int heads, float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        fused_qkv_rope_attn_bias_lse_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const uint8_t*)kmask,
            (bf16*)out, (float*)lse, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_flash_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, int b, int n, int heads,
                                  float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        flash_attn_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
            (bf16*)out, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_flash_attn_lse_bf16(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* lse, int b, int n,
                                      int heads, float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        flash_attn_lse_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lengths,
            (bf16*)out, (float*)lse, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}

extern "C" int f5_masked_flash_attn_bf16(const void* q, const void* k, const void* v,
                                         const void* kmask, void* out, int b, int n, int heads,
                                         float sm_scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + AT_BQ - 1) / AT_BQ, heads, b);
        masked_flash_attn_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)kmask,
            (bf16*)out, n, heads, sm_scale);
    }
    return (int)cudaGetLastError();
}
