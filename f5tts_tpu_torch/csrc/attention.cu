// Forward attention kernels: K3, K7 and K11 (one mma.sync tile loop, with the
// lse modes of K3 and K7) and K5 with its lse mode (wgmma over a cp.async ring).
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
//    fused_qkv_rope_attn_lse_kernel: K3 in the same LSE mode under grad, for
//    its backward K4. The lse is of the scores of K3's pre-scaled bf16 q; the
//    scale 1/8 is a power of two, so that q equals the backward's unscaled
//    roped q times the scale exactly, and the lse is the statistic of the
//    backward's scores.
// K11 masked_flash_attn_kernel: head-layout attention under an arbitrary key
//    mask. Replaces :1653 _flash_kernel_bias (behind :1706
//    masked_flash_attention): MMDiT joint attention when the flat K5 cannot
//    take it (qk-norm, whose per-head RMSNorm comes before RoPE, or unfused
//    projections). K7's head layout in the tile loop's key-mask mode.
//    In:  q, k, v [b, h, n, 64] bf16 (already normed and roped), kmask [b, n]
//         bool. Out: [b, h, n, 64] bf16, every row computed. A batch row with
//         no live key gets zeros (l == 0); the JAX reference gives the
//         uniform mean of v there. No model path makes such a row: the
//         audio's first frame is always live.
//
// The tile loop (K3, K7, K11). Bound: tensor-core operations,
// 4*b*h*n*live_keys*64 flops (8.6 GFLOP at b=2, n=1024, h=16, ~9 us at 989
// TFLOP/s) against ~12 MB of bytes. Design: one 128-thread block per (64-row q
// tile, head, batch). Q is (roped in f32,) scaled by 1/sqrt(d) and kept as bf16
// mma.sync A fragments in registers. The loop over 64-key tiles stops at the
// length (bucket padding costs no compute) or, under a key mask, skips
// all-dead tiles: each tile's K is (roped on load and) stored into shared
// memory, V is stored transposed so the P@V B fragments are single 32-bit
// shared loads; scores and the running (max, sum, acc) stay in f32 registers.
// Dead keys get an additive -1e30 (not -inf, which makes dead rows NaN) and
// l == 0 is guarded as the JAX kernels guard it. Loads are synchronous. The
// modes are compile-time template arguments of one body.
//
// K5 fused_qkv_rope_attn_bias_kernel: flat fused QKV + RoPE attention under an
//    arbitrary key mask. Replaces :1240 _fused_qkv_attn_bias_kernel and :1307
//    _fused_qkv_attn_bias_kernel_stream (MMDiT joint attention: audio padding
//    leaves dead keys in the MIDDLE of the joint audio+text sequence, so no
//    prefix length can express it). fused_qkv_rope_attn_bias_lse_kernel is
//    its LSE mode under grad, for the backward K8.
//    In:  qkv [b, n, 3*h*64] bf16, joint cos/sin [>=n, h*64] bf16 (audio rows
//         rotate with audio positions, text rows with text positions), kmask
//         [b, n] bool; scratch k_rot [b, h, n, 64] bf16.
//    Out: [b, n, h*64] bf16, every row computed (the caller masks dead rows
//         after to_out); the LSE mode also lse [b, h, n] f32 = m + log(l), or
//         -1e30 where l == 0.
//    Function: q and k roped in f32; q multiplied by 1/sqrt(d) and rounded to
//    bf16 once, k rounded to bf16 once (K8 takes this lse as the statistic of
//    its own scores, as K3's above); dead keys add -1e30; f32 online softmax;
//    p rounded to bf16 before P V; l == 0 guarded.
//    Bound: tensor-core operations, 4*h*64 flops a live (query, key) pair, every
//    query row: 0.133 ms at joint 4352 (b = 2, h = 16, 7,388 live keys) against
//    ~89 MB of bytes (0.027 ms). Design, two launches a call:
//     - a prologue ropes k once into k_rot (one thread per 8 lanes of a (row,
//       head)); the main loop never ropes a key tile again;
//     - the main kernel, one warpgroup a block per (64 q rows, head, batch):
//       the block's key-mask row is staged once as a bitmask (one ballot a
//       32-key word) and only tiles with a live key are walked, the mask
//       applied as a select from the bits (none in a tile whose keys are all
//       live), no barrier a tile; the block ropes and scales its 64 q rows
//       once into a 128-byte-swizzled shared tile; K (from k_rot) and V (128 contiguous
//       bytes a row of qkv, no transpose) tiles stream through a two-stage
//       ring filled by cp.async, so the next tile's copy overlaps this tile's
//       products; S = Q K^T is wgmma with both operands in shared memory (K
//       K-major), O += P V wgmma with P from registers (the f32 scores
//       repacked as bf16) and V the N-major B; the online softmax runs in f32
//       on the accumulator layout with exp2f, log2(e) folded into one FMA.
#include "wgmma.cuh"

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

// K3 under grad: the same loop in its LSE mode (the training forward saves
// the row lse for the backward K4).
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

// ---------------------------------------------------------------------------
// K5: key-masked flat attention forward (prologue + wgmma main kernel)
// ---------------------------------------------------------------------------

// One warpgroup a block, at most 168 registers (three blocks an SM; the
// kernel takes ~110, so four fit): measured on the H100 (PERF.md,
// `kernel_ab.py`), two warpgroups a block, a 102-register cap, 128-key tiles,
// and issuing the next tile's S beside this tile's P V (a three-stage or a
// split K / V ring, the softmax overlapping P V) were no faster.
#define FW_NT 128
#define FW_MINB 3
#define FW_LOG2E 1.4426950408889634f
#define FW_SMEM_MAX 232448  // the opt-in maximum of dynamic shared memory
// Shared-memory plan (every tile 1024-aligned): the q tile, two stages of
// (k_rot tile, V tile), then the key mask, one 64-bit word a 64-key tile.
#define FW_STAGE (2 * WG_TILE)
#define FW_FIXED (WG_TILE + 2 * FW_STAGE)

extern __shared__ __align__(16) uint8_t fw_smem[];

// k roped in f32 and rounded to bf16 into krot [b, h, n, 64], one thread per
// 8 lanes of a (row, head).
__global__ void __launch_bounds__(256) fused_qkv_rope_attn_bias_krot_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    bf16* __restrict__ krot, int bsz, int n, int heads) {
    const long long pair = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
    if (pair >= (long long)bsz * n * heads) return;
    const int c = (threadIdx.x & 7) * 8;
    const int hd = heads * 64;
    const long long row = pair / heads;  // b * n + i
    const int hh = (int)(pair - row * heads);
    const int bb = (int)(row / n), i = (int)(row - (long long)bb * n);
    float k[8], cs[8], sn[8];
    unpack8(*reinterpret_cast<const uint4*>(qkv + row * 3 * hd + hd + hh * 64 + c), k);
    unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)i * hd + hh * 64 + c), cs);
    unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)i * hd + hh * 64 + c), sn);
    rope8(k, cs, sn);
    *reinterpret_cast<uint4*>(krot + (((size_t)bb * heads + hh) * n + i) * 64 + c) = pack8(k);
}

template <bool LSE>
__device__ __forceinline__ void bias_fwd(const bf16* __restrict__ qkv,
                                         const bf16* __restrict__ cos_t,
                                         const bf16* __restrict__ sin_t,
                                         const uint8_t* __restrict__ kmask,
                                         const bf16* __restrict__ krot, bf16* __restrict__ out,
                                         float* __restrict__ lse, int n, int heads,
                                         float sm_scale) {
    const int q0 = blockIdx.x * 64;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t row3 = (size_t)3 * hd;
    const size_t bh = (size_t)b * heads + h;

    uint8_t* smem = align1024(fw_smem);
    const uint32_t sQ = smem_u32(smem);
    const uint32_t sStage = sQ + WG_TILE;
    uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + FW_FIXED);  // key j is bit j
    const int n_kt = (n + 63) / 64;
    const bf16* kb = krot + bh * n * 64;
    const bf16* vb = qkv + (size_t)b * n * row3 + 2 * hd + h * 64;

    mask_bits<FW_NT>(sBits, kmask + (size_t)b * n, n, n_kt * 64, tid);
    __syncthreads();
    auto tile_bits = [&](int kt) -> uint64_t {
        return ((uint64_t)sBits[2 * kt + 1] << 32) | sBits[2 * kt];
    };
    auto next_tile = [&](int kt) -> int {  // the first tile >= kt with a live key
        while (kt < n_kt && !tile_bits(kt)) ++kt;
        return kt;
    };
    auto load_stage = [&](int k0, int s) {
        const uint32_t st = sStage + s * FW_STAGE;
        tile_async<FW_NT>(st, kb, 64, k0, n, tid);
        tile_async<FW_NT>(st + WG_TILE, vb, row3, k0, n, tid);
        cp_async_commit();
    };
    int kt = next_tile(0);
    if (kt < n_kt) load_stage(kt * 64, 0);
    else cp_async_commit();

    // q rows roped in f32, * 1/sqrt(d), rounded to bf16, into the swizzled
    // q tile (while the first K / V copy is in flight); rows >= n are 0
    {
        const bf16* qb = qkv + (size_t)b * n * row3 + h * 64;
        for (int i = tid; i < 64 * 8; i += FW_NT) {
            const int r = i >> 3, c = i & 7;
            const int row = q0 + r;
            float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (row < n) {
                float cs[8], sn[8];
                unpack8(*reinterpret_cast<const uint4*>(qb + row * row3 + c * 8), f);
                unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)row * hd + h * 64 + c * 8), cs);
                unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)row * hd + h * 64 + c * 8), sn);
                rope8(f, cs, sn);
#pragma unroll
                for (int e = 0; e < 8; ++e) f[e] *= sm_scale;
            }
            *reinterpret_cast<uint4*>(smem + sw128_off(r, c)) = pack8(f);
        }
    }

    // this thread's two accumulator rows are queries row_lo and row_lo + 8
    const int row_lo = q0 + warp * 16 + g;
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m_run[2] = {AT_NEG, AT_NEG}, l_run[2] = {0.f, 0.f};
    for (int it = 0; kt < n_kt; ++it) {
        const int s = it & 1;
        cp_async_wait_all();
        __syncthreads();  // stage s (and the q tile) landed; every thread is done with stage s ^ 1
        const int nxt = next_tile(kt + 1);
        if (nxt < n_kt) load_stage(nxt * 64, s ^ 1);
        const uint32_t sK = sStage + s * FW_STAGE, sV = sK + WG_TILE;
        const uint64_t bits = tile_bits(kt);

        float sc[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // S = Q K^T: 64 queries x 64 keys (q pre-scaled)
            wgmma_ss<0>(sc, sw128_desc(sQ + kk * 32), sw128_desc(sK + kk * 32), kk);
        wg_commit();
        wg_wait0();
        fence_regs(sc);

        // dead keys: -1e30 (the plain version's additive row), selected only
        // in a tile with a dead key; the tile holds a live key, so every
        // row's max is finite and their p is 0. This thread's keys nt * 8 +
        // t4 * 2 + {0, 1} are bits nt * 8 + {0, 1} of bits >> (t4 * 2).
        if (bits != ~0ull) {
            const uint64_t kbits = bits >> (t4 * 2);
#pragma unroll
            for (int i = 0; i < 32; ++i)
                if (!((kbits >> ((i >> 2) * 8 + (i & 1))) & 1)) sc[i] = AT_NEG;
        }
        float mx[2] = {AT_NEG, AT_NEG};
#pragma unroll
        for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2], m2[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            alpha[r] = exp2f((m_run[r] - m_new) * FW_LOG2E);
            m_run[r] = m_new;
            m2[r] = m_new * FW_LOG2E;
            l_run[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const float p = exp2f(fmaf(sc[i], FW_LOG2E, -m2[(i >> 1) & 1]));
            sc[i] = p;
            l_run[(i >> 1) & 1] += p;
            o[i] *= alpha[(i >> 1) & 1];
        }
        uint32_t pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) acc_to_a(pa[kc], sc, kc);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)  // O += P V (V N-major: 16 keys a step)
            wgmma_rs<1>(o, pa[kc], sw128_desc(sV + kc * 2048), 1);
        wg_commit();
        wg_wait0();
        fence_regs(o);
        kt = nxt;
    }
    cp_async_wait_all();

    // finish: quad-reduce l, normalise, write the flat rows (and the lse)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row_lo + r * 8;
        if (row >= n) continue;
        const float inv = l_run[r] != 0.f ? 1.f / l_run[r] : 0.f;
        if (LSE && t4 == 0)
            lse[bh * n + row] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : AT_NEG;
        bf16* orow = out + ((size_t)b * n + row) * hd + h * 64 + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<uint32_t*>(orow + nt * 8) =
                pack_bf16x2(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
    }
}

#define BIAS_FWD_ARGS                                                                             \
    const bf16 *__restrict__ qkv, const bf16 *__restrict__ cos_t, const bf16 *__restrict__ sin_t, \
        const uint8_t *__restrict__ kmask, const bf16 *__restrict__ krot, bf16 *__restrict__ out, \
        float *__restrict__ lse, int n, int heads, float sm_scale

__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_bias_kernel(BIAS_FWD_ARGS) {
    bias_fwd<false>(qkv, cos_t, sin_t, kmask, krot, out, lse, n, heads, sm_scale);
}
__global__ void __launch_bounds__(FW_NT, FW_MINB) fused_qkv_rope_attn_bias_lse_kernel(BIAS_FWD_ARGS) {
    bias_fwd<true>(qkv, cos_t, sin_t, kmask, krot, out, lse, n, heads, sm_scale);
}

static int launch_bias_fwd(bool with_lse, const void* qkv, const void* cos_t, const void* sin_t,
                           const void* kmask, void* out, void* lse, void* k_rot, int b, int n,
                           int heads, float sm_scale, void* stream) {
    if (b <= 0 || n <= 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const size_t rows = (size_t)b * n * heads;
    fused_qkv_rope_attn_bias_krot_kernel<<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(
        (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (bf16*)k_rot, b, n, heads);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    auto kernel = with_lse ? fused_qkv_rope_attn_bias_lse_kernel : fused_qkv_rope_attn_bias_kernel;
    const int smem = 1024 + FW_FIXED + (n + 63) / 64 * 8;
    if (smem > FW_SMEM_MAX) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((n + 63) / 64, heads, b);
    kernel<<<grid, FW_NT, smem, s>>>((const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t,
                                     (const uint8_t*)kmask, (const bf16*)k_rot, (bf16*)out,
                                     (float*)lse, n, heads, sm_scale);
    return (int)cudaGetLastError();
}

extern "C" int f5_fused_qkv_rope_attn_bias_bf16(const void* qkv, const void* cos_t,
                                                const void* sin_t, const void* kmask, void* out,
                                                void* k_rot, int b, int n, int heads,
                                                float sm_scale, void* stream) {
    return launch_bias_fwd(false, qkv, cos_t, sin_t, kmask, out, nullptr, k_rot, b, n, heads,
                           sm_scale, stream);
}

extern "C" int f5_fused_qkv_rope_attn_bias_lse_bf16(const void* qkv, const void* cos_t,
                                                    const void* sin_t, const void* kmask,
                                                    void* out, void* lse, void* k_rot, int b,
                                                    int n, int heads, float sm_scale,
                                                    void* stream) {
    return launch_bias_fwd(true, qkv, cos_t, sin_t, kmask, out, lse, k_rot, b, n, heads,
                           sm_scale, stream);
}
