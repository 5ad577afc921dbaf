// K2: ConvPositionEmbedding, one same-padded grouped conv1d (64 channels a
// group, k <= 31) + bias + length mask + Mish per launch.
//
// Replaces f5tts_tpu/ops/grouped_conv.py:168 _cpe_kernel. The module is two
// launches of this kernel with the intermediate activation rounded to bf16 in
// device memory between them, as the Pallas kernel rounds it
// (grouped_conv.py:180-184); recomputing conv1 over a 15-row halo inside one
// launch would cost 47% more conv1 work at 64-row tiles, against 4 MB of
// round trip at n = 1024.
//
// Bound: tensor-core operations. 2 convs * 2*n*64*31*c flops (8.3 GFLOP at
// n = 1024, c = 1024, ~8.4 us at 989 TFLOP/s) against ~6 MB of bytes.
// Design: one 128-thread block per (64-row tile, group, batch). The tile's
// input rows plus the 30-row halo sit in shared memory as bf16, with rows at
// or past the length and outside [0, n) zeroed; each of the k taps is a
// [64 x 64] @ [64 x 64] product on mma.sync with f32 accumulators in
// registers, the tap's weights staged transposed through shared memory.
// Weights stay in the JAX package's WIO layout (k, 64, c). Loads are
// synchronous; a cp.async/TMA weight pipeline and wgmma are later work.
//
// K10: the generic same-padded grouped conv1d + bias, any W = c / groups
// channels a group with W % 8 == 0 and W <= 128, 1 <= k <= 31, any n.
// Replaces f5tts_tpu/ops/grouped_conv.py:27 _grouped_conv_kernel (+ its bias
// add, :80): the conv-position module of the dim-768 presets (48 channels a
// group), whose mask and Mish stay PyTorch elementwise ops between two
// launches, as the JAX package leaves them to XLA. K2's tile loop with the
// padded group width WP (W rounded up to 16) a template parameter: lanes
// W..WP of the x tile and of the staged weights are zero, so the mma.sync
// tiles stay 16 wide. The epilogue adds the bias in f32 and rounds once to
// bf16 (the Pallas path rounds the conv, then adds a bf16 bias: at most one
// bf16 ulp apart). No length mask, no activation. Dynamic shared memory:
// (64 + k - 1 + WP) rows of WP + 8 bf16, 60 KB at WP = 128, k = 31.
#include "common.cuh"

#define CV_W 64     // channels per group
#define CV_BM 64    // output rows per block
#define CV_MAXK 31
#define CV_LDS 72

__device__ __forceinline__ float mish_f32(float v) {
    // softplus as jax.nn.softplus computes it: max(v, 0) + log1p(exp(-|v|))
    const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
}

__global__ void __launch_bounds__(128) conv_mish_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const int* __restrict__ lengths, bf16* __restrict__ y, int n, int c, int ksize) {
    const int r0 = blockIdx.x * CV_BM;
    const int gi = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int len = min(max(lengths[b], 0), n);
    const int lead = (ksize - 1) / 2;
    const int rows_in = CV_BM + ksize - 1;
    const size_t cg = (size_t)gi * CV_W;

    if (r0 >= len) {  // masked rows: mish(0) = 0
        for (int i = tid; i < CV_BM * 8; i += 128) {
            const int row = r0 + (i >> 3);
            if (row < n)
                *reinterpret_cast<uint4*>(y + ((size_t)b * n + row) * c + cg + (i & 7) * 8) =
                    make_uint4(0, 0, 0, 0);
        }
        return;
    }

    __shared__ __align__(16) bf16 sX[(CV_BM + CV_MAXK - 1) * CV_LDS];
    __shared__ __align__(16) bf16 sW[CV_W * CV_LDS];  // tap weights, [out][in]

    for (int i = tid; i < rows_in * 8; i += 128) {
        const int r = i >> 3, col = (i & 7) * 8;
        const int src = r0 - lead + r;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (src >= 0 && src < len)
            v = *reinterpret_cast<const uint4*>(x + ((size_t)b * n + src) * c + cg + col);
        *reinterpret_cast<uint4*>(sX + r * CV_LDS + col) = v;
    }

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    for (int tap = 0; tap < ksize; ++tap) {
        __syncthreads();  // sW of the previous tap is consumed (and sX is ready)
        // w[tap, in, gi*64 + out] -> sW[out][in], input channels paired
        const bf16* wt = w + (size_t)tap * CV_W * c + cg;
        for (int i = tid; i < 32 * 8; i += 128) {
            const int ip = i & 31, o0 = (i >> 5) * 8;
            float a[8], bb[8];
            unpack8(*reinterpret_cast<const uint4*>(wt + (size_t)(2 * ip) * c + o0), a);
            unpack8(*reinterpret_cast<const uint4*>(wt + (size_t)(2 * ip + 1) * c + o0), bb);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<uint32_t*>(sW + (o0 + j) * CV_LDS + 2 * ip) =
                    pack_bf16x2(a[j], bb[j]);
        }
        __syncthreads();

        const bf16* x_lo = sX + (warp * 16 + g + tap) * CV_LDS + t4 * 2;
        const bf16* x_hi = x_lo + 8 * CV_LDS;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            uint32_t a[4];
            a[0] = lds32(x_lo + kk * 16);
            a[1] = lds32(x_hi + kk * 16);
            a[2] = lds32(x_lo + kk * 16 + 8);
            a[3] = lds32(x_hi + kk * 16 + 8);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
                const bf16* wr = sW + (nt * 8 + g) * CV_LDS + kk * 16 + t4 * 2;
                mma_16816(acc[nt], a, lds32(wr), lds32(wr + 8));
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + g + r * 8;
        if (row >= n) continue;
        bf16* yr = y + ((size_t)b * n + row) * c + cg + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + t4 * 2;
            float v0 = 0.f, v1 = 0.f;
            if (row < len) {
                v0 = mish_f32(acc[nt][2 * r] + __bfloat162float(bias[cg + col]));
                v1 = mish_f32(acc[nt][2 * r + 1] + __bfloat162float(bias[cg + col + 1]));
            }
            *reinterpret_cast<uint32_t*>(yr + nt * 8) = pack_bf16x2(v0, v1);
        }
    }
}

extern "C" int f5_conv_mish_bf16(const void* x, const void* w, const void* bias,
                                 const void* lengths, void* y, int b, int n, int c,
                                 int ksize, void* stream) {
    if (b > 0 && n > 0) {
        dim3 grid((n + CV_BM - 1) / CV_BM, c / CV_W, b);
        conv_mish_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
            (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const int*)lengths,
            (bf16*)y, n, c, ksize);
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10: generic grouped conv1d + bias
// ---------------------------------------------------------------------------

template <int WP>
__global__ void __launch_bounds__(128) grouped_conv1d_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    bf16* __restrict__ y, int n, int c, int width, int ksize) {
    constexpr int LDS = WP + 8;  // padded shared row: conflict-free fragment loads
    constexpr int NT = WP / 8;   // 8-column mma tiles of the output
    extern __shared__ __align__(16) unsigned char gc_smem[];
    const int rows_in = CV_BM + ksize - 1;
    bf16* sX = reinterpret_cast<bf16*>(gc_smem);  // [rows_in][LDS] input rows + halo
    bf16* sW = sX + rows_in * LDS;                // [WP][LDS] tap weights, [out][in]

    const int r0 = blockIdx.x * CV_BM;
    const int gi = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int lead = (ksize - 1) / 2;
    const size_t cg = (size_t)gi * width;
    const uint4 zero4 = make_uint4(0, 0, 0, 0);

    for (int i = tid; i < rows_in * NT; i += 128) {
        const int r = i / NT, col = (i % NT) * 8;
        const int src = r0 - lead + r;
        uint4 v = zero4;
        if (col < width && src >= 0 && src < n)
            v = *reinterpret_cast<const uint4*>(x + ((size_t)b * n + src) * c + cg + col);
        *reinterpret_cast<uint4*>(sX + r * LDS + col) = v;
    }
    if (width < WP)  // the pad lanes of sW stay zero through every tap
        for (int i = tid; i < WP * LDS / 8; i += 128)
            *reinterpret_cast<uint4*>(sW + i * 8) = zero4;

    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

    const int pairs = width / 2;
    for (int tap = 0; tap < ksize; ++tap) {
        __syncthreads();  // sW of the previous tap is consumed (and sX, sW pads are ready)
        // w[tap, in, gi*W + out] -> sW[out][in], input channels paired
        const bf16* wt = w + (size_t)tap * width * c + cg;
        for (int i = tid; i < pairs * (width / 8); i += 128) {
            const int ip = i % pairs, o0 = (i / pairs) * 8;
            float a[8], bb[8];
            unpack8(*reinterpret_cast<const uint4*>(wt + (size_t)(2 * ip) * c + o0), a);
            unpack8(*reinterpret_cast<const uint4*>(wt + (size_t)(2 * ip + 1) * c + o0), bb);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                *reinterpret_cast<uint32_t*>(sW + (o0 + j) * LDS + 2 * ip) =
                    pack_bf16x2(a[j], bb[j]);
        }
        __syncthreads();

        const bf16* x_lo = sX + (warp * 16 + g + tap) * LDS + t4 * 2;
        const bf16* x_hi = x_lo + 8 * LDS;
#pragma unroll
        for (int kk = 0; kk < WP / 16; ++kk) {
            uint32_t a[4];
            a[0] = lds32(x_lo + kk * 16);
            a[1] = lds32(x_hi + kk * 16);
            a[2] = lds32(x_lo + kk * 16 + 8);
            a[3] = lds32(x_hi + kk * 16 + 8);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const bf16* wr = sW + (nt * 8 + g) * LDS + kk * 16 + t4 * 2;
                mma_16816(acc[nt], a, lds32(wr), lds32(wr + 8));
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = r0 + warp * 16 + g + r * 8;
        if (row >= n) continue;
        bf16* yr = y + ((size_t)b * n + row) * c + cg + t4 * 2;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + t4 * 2;
            if (nt * 8 >= width) break;
            const float v0 = acc[nt][2 * r] + __bfloat162float(bias[cg + col]);
            const float v1 = acc[nt][2 * r + 1] + __bfloat162float(bias[cg + col + 1]);
            *reinterpret_cast<uint32_t*>(yr + nt * 8) = pack_bf16x2(v0, v1);
        }
    }
}

template <int WP>
static void launch_grouped_conv1d(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
                                  int b, int n, int c, int width, int ksize,
                                  cudaStream_t stream) {
    const size_t smem = (size_t)(CV_BM + ksize - 1 + WP) * (WP + 8) * sizeof(bf16);
    if (smem > 48 * 1024)
        cudaFuncSetAttribute(grouped_conv1d_kernel<WP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    dim3 grid((n + CV_BM - 1) / CV_BM, c / width, b);
    grouped_conv1d_kernel<WP><<<grid, 128, smem, stream>>>(x, w, bias, y, n, c, width, ksize);
}

extern "C" int f5_grouped_conv1d_bf16(const void* x, const void* w, const void* bias, void* y,
                                      int b, int n, int c, int width, int ksize, void* stream) {
    if (width <= 0 || width % 8 || width > 128 || c % width || ksize < 1 || ksize > CV_MAXK)
        return (int)cudaErrorInvalidValue;
    if (b > 0 && n > 0) {
        const bf16 *xp = (const bf16*)x, *wp = (const bf16*)w, *bp = (const bf16*)bias;
        bf16* yp = (bf16*)y;
        cudaStream_t s = (cudaStream_t)stream;
        switch ((width + 15) / 16 * 16) {
            case 16: launch_grouped_conv1d<16>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 32: launch_grouped_conv1d<32>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 48: launch_grouped_conv1d<48>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 64: launch_grouped_conv1d<64>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 80: launch_grouped_conv1d<80>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 96: launch_grouped_conv1d<96>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            case 112: launch_grouped_conv1d<112>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
            default: launch_grouped_conv1d<128>(xp, wp, bp, yp, b, n, c, width, ksize, s); break;
        }
    }
    return (int)cudaGetLastError();
}
