// K4: dQKV of K3 (fused QKV + interleaved RoPE + length-masked attention), flat layout.
//
// Replaces f5tts_tpu/ops/attention.py:886 _fused_qkv_bwd_kernel (n <= 1024) and
// :970 _fused_qkv_bwd_kernel_long (1024 < n <= 4096, launched from :1077) with one pair
// of kernels for every n <= 4096 (any n, the tail tile included).
//
// In:  qkv [b, n, 3*h*64] bf16 (the forward's input), cos/sin [>=n, h*64] bf16,
//      lengths [b] int32, dO [b, n, h*64] bf16 (the incoming gradient).
// Out: dQKV [b, n, 3*h*64] bf16; scratch lse/delta [b, h, n] f32.
//
// What it computes, as the Pallas kernels do (attention.py:876-959): q and k are
// re-roped in f32 and rounded to bf16 (q NOT pre-scaled); s = q_rot k_rot^T *
// scale + key bias (-1e30 past the length); p = softmax(s) in f32; dp = dO v^T;
// delta = rowsum(p * dp); ds = p * (dp - delta); ds and p are rounded to bf16
// before dv = p^T dO, dk = ds^T q_rot and dq = ds k_rot (f32 accumulators);
// dq and dk are multiplied by the scale and un-roped (rope with -sin).
// Dead query rows (>= length) are K3's zero rows, so their exact gradient is 0
// for any dO: dO is read as 0 there (the Pallas kernels rely on the caller's
// mask instead). Dead keys get p = 0, so their dk and dv are exactly 0.
//
// Bound: tensor-core operations, 10*h*64*sum(len^2) flops (5 products) against
// ~(3 + 1 + 3)*b*n*h*64*2 bytes. Design (simple first; wgmma/TMA later):
//  - dq kernel, one 128-thread block per (64-row q tile, head, batch), each warp
//    16 rows with Q and dO as mma.sync A fragments in registers. Pass 1 over the
//    64-key tiles up to the length: the row max/sum and sum(exp(s - m) * dp)
//    online, giving lse and delta (written f32 [b, h, n] for the dk/dv kernel).
//    Pass 2: p = exp(s - lse), ds, dq += ds K (K's B fragments by ldmatrix.trans).
//  - dk/dv kernel, one block per (64-key tile, head, batch), each warp 16 keys
//    with K and V as A fragments: loops over the live q tiles computing s^T and
//    dp^T directly, dv += p^T dO and dk += ds^T Q in f32 registers.
// No atomics and no [n, n] tensor in device memory. Loads are synchronous.
#include "common.cuh"

#define BW_T 64     // rows of a q tile and of a key tile
#define BW_LDS 72   // padded shared row (bf16): conflict-free fragment loads
#define BW_NEG -1e30f

// 64 rows x 64 lanes of q (sect 0) or k (sect 1) of head h, roped in f32, as bf16.
__device__ __forceinline__ void load_roped(bf16* dst, const bf16* qkvb, const bf16* cos_t,
                                           const bf16* sin_t, int r0, int n, int sect,
                                           int h, int hd, int tid) {
    const size_t row3 = (size_t)3 * hd;
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = r0 + r;
        float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (row < n) {
            float cs[8], sn[8];
            unpack8(*reinterpret_cast<const uint4*>(qkvb + row * row3 + sect * hd + h * 64 + c), f);
            unpack8(*reinterpret_cast<const uint4*>(cos_t + (size_t)row * hd + h * 64 + c), cs);
            unpack8(*reinterpret_cast<const uint4*>(sin_t + (size_t)row * hd + h * 64 + c), sn);
            rope8(f, cs, sn);
        }
        *reinterpret_cast<uint4*>(dst + r * BW_LDS + c) = pack8(f);
    }
}

// 64 rows x 64 lanes of bf16 from src (row stride `stride`); rows >= lim read as 0.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, size_t stride, int r0,
                                          int lim, int tid) {
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int r = i >> 3, c = (i & 7) * 8;
        const int row = r0 + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < lim) v = *reinterpret_cast<const uint4*>(src + row * stride + c);
        *reinterpret_cast<uint4*>(dst + r * BW_LDS + c) = v;
    }
}

// Zero 64 lanes of rows [r0, min(r0 + 64, n)) of dst (row stride `stride`).
__device__ __forceinline__ void zero_rows(bf16* dst, size_t stride, int r0, int n, int tid) {
    for (int i = tid; i < BW_T * 8; i += 128) {
        const int row = r0 + (i >> 3);
        if (row < n)
            *reinterpret_cast<uint4*>(dst + row * stride + (i & 7) * 8) = make_uint4(0, 0, 0, 0);
    }
}

// A fragments of this warp's 16 rows of a [64][64] shared tile.
__device__ __forceinline__ void load_a(uint32_t a[4][4], const bf16* tile, int warp, int g,
                                       int t4) {
    const bf16* lo = tile + (warp * 16 + g) * BW_LDS + t4 * 2;
    const bf16* hi = lo + 8 * BW_LDS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = lds32(lo + kk * 16);
        a[kk][1] = lds32(hi + kk * 16);
        a[kk][2] = lds32(lo + kk * 16 + 8);
        a[kk][3] = lds32(hi + kk * 16 + 8);
    }
}

// c[16 x 64] = A[16 x 64] . T^T for a row-major shared tile T [64 rows][64 lanes].
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[4][4], const bf16* tile,
                                        int g, int t4) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
        const bf16* r = tile + (nt * 8 + g) * BW_LDS + t4 * 2;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            mma_16816(c[nt], a[kk], lds32(r + kk * 16), lds32(r + kk * 16 + 8));
    }
}

// acc[16 x 64] += bf16(P)[16 x 64] . T with P in accumulator layout (its 64
// columns are the contraction) and T a row-major shared tile [64][64 lanes].
__device__ __forceinline__ void mma_pt(float acc[8][4], const float p[8][4], const bf16* tile,
                                       int lane) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        uint32_t pa[4];
        pa[0] = pack_bf16x2(p[2 * kc][0], p[2 * kc][1]);
        pa[1] = pack_bf16x2(p[2 * kc][2], p[2 * kc][3]);
        pa[2] = pack_bf16x2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
        pa[3] = pack_bf16x2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
        const bf16* base = tile + (kc * 16 + (lane & 15)) * BW_LDS + (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < 4; ++dp) {
            uint32_t bfr[4];
            ldsm_x4_trans(bfr, base + dp * 16);
            mma_16816(acc[2 * dp], pa, bfr[0], bfr[1]);
            mma_16816(acc[2 * dp + 1], pa, bfr[2], bfr[3]);
        }
    }
}

// Scale, optionally un-rope (rope with -sin), and store this warp's 16 rows of
// an accumulator as bf16 lanes h*64.. of dst (row stride `stride`).
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride, float acc[8][4], int row0,
                                           int n, int h, int hd, float scale, bool unrope,
                                           const bf16* cos_t, const bf16* sin_t, int t4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= n) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int lane_d = h * 64 + nt * 8 + t4 * 2;
            float x0 = acc[nt][2 * r] * scale, x1 = acc[nt][2 * r + 1] * scale;
            if (unrope) {
                const float2 c = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(cos_t + (size_t)row * hd + lane_d));
                const float2 s = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(sin_t + (size_t)row * hd + lane_d));
                const float y0 = x0 * c.x + x1 * s.x;
                const float y1 = x1 * c.y - x0 * s.y;
                x0 = y0;
                x1 = y1;
            }
            *reinterpret_cast<uint32_t*>(dst + row * stride + nt * 8 + t4 * 2) = pack_bf16x2(x0, x1);
        }
    }
}

__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int n, int heads, float scale) {
    const int q0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = min(max(lengths[b], 0), n);
    const size_t row3 = (size_t)3 * hd;
    const bf16* qkvb = qkv + (size_t)b * n * row3;
    bf16* dqb = dqkv + (size_t)b * n * row3 + h * 64;

    if (q0 >= len) {  // dead q tile: dq = 0
        zero_rows(dqb, row3, q0, n, tid);
        return;
    }

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];

    load_roped(sQ, qkvb, cos_t, sin_t, q0, n, 0, h, hd, tid);
    load_rows(sO, dout + (size_t)b * n * hd + h * 64, hd, q0, len, tid);
    __syncthreads();
    uint32_t qa[4][4], oa[4][4];
    load_a(qa, sQ, warp, g, t4);
    load_a(oa, sO, warp, g, t4);

    const int row_lo = q0 + warp * 16 + g;
    const int n_kt = (len + BW_T - 1) / BW_T;
    float s[8][4], dp[8][4];

    // pass 1: m, l and sum(exp(s - m) * dp) per row, online over the key tiles
    float m_run[2] = {BW_NEG, BW_NEG}, l_run[2] = {0.f, 0.f}, d_run[2] = {0.f, 0.f};
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BW_T;
        __syncthreads();
        load_roped(sK, qkvb, cos_t, sin_t, k0, n, 1, h, hd, tid);
        load_rows(sV, qkvb + 2 * hd + h * 64, row3, k0, n, tid);
        __syncthreads();
        mma_abt(s, qa, sK, g, t4);
        mma_abt(dp, oa, sV, g, t4);
        float mx[2] = {BW_NEG, BW_NEG};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int key = k0 + nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                s[nt][e] = s[nt][e] * scale + (key + (e & 1) < len ? 0.f : BW_NEG);
                mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            const float alpha = __expf(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= alpha;
            d_run[r] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pe = __expf(s[nt][e] - m_run[e >> 1]);
                l_run[e >> 1] += pe;
                d_run[e >> 1] += pe * dp[nt][e];
            }
    }
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 1);
        d_run[r] += __shfl_xor_sync(0xffffffffu, d_run[r], 2);
        const int row = row_lo + r * 8;
        // l == 0 guard (as the Pallas kernel's): p = 0 for such a row
        lse[r] = l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : INFINITY;
        dlt[r] = (row < len && l_run[r] > 0.f) ? d_run[r] / l_run[r] : 0.f;
        if (t4 == 0 && row < n) {
            const size_t at = ((size_t)b * heads + h) * n + row;
            lse_out[at] = lse[r];
            delta_out[at] = dlt[r];
        }
    }

    // pass 2: ds = p * (dp - delta), dq += ds K
    float dq[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * BW_T;
        __syncthreads();
        load_roped(sK, qkvb, cos_t, sin_t, k0, n, 1, h, hd, tid);
        load_rows(sV, qkvb + 2 * hd + h * 64, row3, k0, n, tid);
        __syncthreads();
        mma_abt(s, qa, sK, g, t4);
        mma_abt(dp, oa, sV, g, t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int key = k0 + nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const bool live = key + (e & 1) < len && row_lo + r * 8 < len;
                const float p = live ? __expf(s[nt][e] * scale - lse[r]) : 0.f;
                s[nt][e] = p * (dp[nt][e] - dlt[r]);
            }
        }
        mma_pt(dq, s, sK, lane);
    }
    store_rows(dqb, row3, dq, row_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
}

__global__ void __launch_bounds__(128) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ qkv, const bf16* __restrict__ cos_t, const bf16* __restrict__ sin_t,
    const int* __restrict__ lengths, const bf16* __restrict__ dout,
    const float* __restrict__ lse_in, const float* __restrict__ delta_in,
    bf16* __restrict__ dqkv, int n, int heads, float scale) {
    const int k0 = blockIdx.x * BW_T;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hd = heads * 64;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = min(max(lengths[b], 0), n);
    const size_t row3 = (size_t)3 * hd;
    const bf16* qkvb = qkv + (size_t)b * n * row3;
    bf16* dkb = dqkv + (size_t)b * n * row3 + hd + h * 64;
    bf16* dvb = dkb + hd;

    if (k0 >= len) {  // dead key tile: dk = dv = 0
        zero_rows(dkb, row3, k0, n, tid);
        zero_rows(dvb, row3, k0, n, tid);
        return;
    }

    __shared__ __align__(16) bf16 sQ[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sO[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sK[BW_T * BW_LDS];
    __shared__ __align__(16) bf16 sV[BW_T * BW_LDS];
    __shared__ float sL[BW_T], sD[BW_T];

    load_roped(sK, qkvb, cos_t, sin_t, k0, n, 1, h, hd, tid);
    load_rows(sV, qkvb + 2 * hd + h * 64, row3, k0, n, tid);
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    load_a(ka, sK, warp, g, t4);
    load_a(va, sV, warp, g, t4);

    const int key_lo = k0 + warp * 16 + g;
    const float* lseb = lse_in + ((size_t)b * heads + h) * n;
    const float* deltab = delta_in + ((size_t)b * heads + h) * n;
    float dk[8][4], dv[8][4], st[8][4], dpt[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }
    const int n_qt = (len + BW_T - 1) / BW_T;  // only live q tiles
    for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BW_T;
        __syncthreads();
        load_roped(sQ, qkvb, cos_t, sin_t, q0, n, 0, h, hd, tid);
        load_rows(sO, dout + (size_t)b * n * hd + h * 64, hd, q0, len, tid);
        if (tid < BW_T) {
            const int row = q0 + tid;
            sL[tid] = row < len ? lseb[row] : 0.f;
            sD[tid] = row < len ? deltab[row] : 0.f;
        }
        __syncthreads();
        mma_abt(st, ka, sQ, g, t4);   // s^T: this warp's 16 keys x 64 queries
        mma_abt(dpt, va, sO, g, t4);  // dp^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int ql = nt * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int qi = ql + (e & 1);
                const bool live = key_lo + (e >> 1) * 8 < len && q0 + qi < len;
                const float p = live ? __expf(st[nt][e] * scale - sL[qi]) : 0.f;
                st[nt][e] = p;
                dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
            }
        }
        mma_pt(dv, st, sO, lane);   // dv += p^T dO
        mma_pt(dk, dpt, sQ, lane);  // dk += ds^T q_rot
    }
    store_rows(dkb, row3, dk, key_lo, n, h, hd, scale, true, cos_t, sin_t, t4);
    store_rows(dvb, row3, dv, key_lo, n, h, hd, 1.f, false, cos_t, sin_t, t4);
}

extern "C" int f5_fused_qkv_rope_attn_bwd_bf16(const void* qkv, const void* cos_t,
                                               const void* sin_t, const void* lengths,
                                               const void* dout, void* dqkv, void* lse,
                                               void* delta, int b, int n, int heads,
                                               float scale, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + BW_T - 1) / BW_T, heads, b);
        cudaStream_t s = (cudaStream_t)stream;
        attn_bwd_dq_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const int*)lengths,
            (const bf16*)dout, (bf16*)dqkv, (float*)lse, (float*)delta, n, heads, scale);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        attn_bwd_dkdv_kernel<<<grid, 128, 0, s>>>(
            (const bf16*)qkv, (const bf16*)cos_t, (const bf16*)sin_t, (const int*)lengths,
            (const bf16*)dout, (const float*)lse, (const float*)delta, (bf16*)dqkv, n, heads,
            scale);
    }
    return (int)cudaGetLastError();
}
