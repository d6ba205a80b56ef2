// K6 tonemap_rgb8: HDR -> display uint8 in one pass, with the bloom's
// composite folded in.
//
// Replaces: ptrt_tpu/render/pipeline.py:tonemap_to_rgb8, i.e. the XLA
// fusion of core/color.py:aces_tonemap, srgb_oetf and to_rgb8 plus the
// Y-flip; and, given the bloom chain's mip 0, the last step of
// ptrt_tpu/render/bloom.py:apply_bloom (:118), hdr + up(mip 0).
//
// What bounds it on the card: per pixel it reads 12 bytes (three float
// planes), with the bloom 3 more (mip 0 is a quarter of the image), and
// writes 3 bytes: 31 MB (37 MB with the bloom) at 1080p, 9.3 us (11.1 us)
// at the H100's 3.35 TB/s.  The arithmetic is not small beside that: two
// 3x3 matrices and three IEEE divisions (the ACES fit) a pixel, and the
// exact sRGB OETF's three powf, ~85 instructions a channel with the
// quantisation, no fast-math: with powf the warps' instructions bound it
// (tools/stages.py counts them from the SASS).
//
// What this design does about it: a thread takes four neighbouring pixels
// of one row (the row is the block's y, so no division finds it): 16-byte
// loads of the three planes and three 4-byte stores of the 12 interleaved
// bytes where the width is a multiple of 4 (one pixel at a time, byte
// stores, otherwise).  The bloom composite reads its four taps a channel
// from mip 0 through L1, with the wrapper's upsample tables (row once a
// thread).  The OETF and quantisation are a table built by the wrapper
// from the plain encode itself (pipeline.encode_lut): the float's top 16
// bits index a word that holds the byte and the one threshold the bucket
// may hold, read through L1 — seven instructions a channel.  It equals the
// plain encode wherever that is monotone.  This file builds with
// -fmad=false so the composite and the matrices round as the plain version
// does; constants are the float32 roundings of the reference's literals.

#include <cuda_runtime.h>
#include <stdint.h>

struct TonemapArgs {
    const float* hdr[3];
    const float* bloom[3];  // mip 0 after the upsample-add chain, or null
    const int* bx;          // upsample columns: x0, x1, uf bits; 3 rows of w
    const int* by;          // upsample rows: y0, y1, vf bits; 3 rows of h
    const int* lut;         // the encode's table (pipeline.encode_lut)
    uint8_t* out;
    int h, w, bw;
    float scale;
};

namespace {

constexpr int kThreads = 128;
constexpr int kPix = 4;  // pixels a thread

__device__ __forceinline__ float clamp01(float v) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float aces_fit(float ac) {
    const float a = ac * (ac + 0.0245786f) - 0.000090537f;
    const float b = ac * (ac * 0.983729f + 0.4329510f) + 0.238081f;
    return clamp01(a / b);
}

// the byte from the encode's table (pipeline.encode_lut): one word for each
// 2^16 float bit patterns of [0, 1], the byte at the bucket's start (bits
// 17 up) and where in the bucket the one threshold it may hold lies (low
// 17 bits; 2^16 where none)
__device__ __forceinline__ uint32_t encode_lut(float v, const int* lut) {
    const uint32_t b = __float_as_uint(v) & 0x7fffffffu;  // -0 is 0
    const uint32_t e = static_cast<uint32_t>(__ldg(lut + (b >> 16)));
    return (e >> 17) + ((b & 0xffffu) >= (e & 0x1ffffu) ? 1u : 0u);
}

template <bool kBloom, bool kVec>
__global__ void __launch_bounds__(kThreads)
tonemap_rgb8_kernel(const TonemapArgs a) {
    const int y = blockIdx.y;
    const int x = (blockIdx.x * kThreads + threadIdx.x) * kPix;
    if (x >= a.w) return;
    const int n = min(kPix, a.w - x);
    const size_t at = static_cast<size_t>(y) * a.w + x;
    float c[3][kPix];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (kVec) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(a.hdr[k]
                                                                   + at));
            c[k][0] = v.x;
            c[k][1] = v.y;
            c[k][2] = v.z;
            c[k][3] = v.w;
        } else {
#pragma unroll
            for (int p = 0; p < kPix; ++p)
                c[k][p] = p < n ? __ldg(a.hdr[k] + at + p) : 0.0f;
        }
    }
    if (kBloom) {
        // hdr + up(mip 0), as render/bloom.py upsample_bilinear
        const int h = a.h, w = a.w;
        const size_t r0 = static_cast<size_t>(__ldg(a.by + y)) * a.bw;
        const size_t r1 = static_cast<size_t>(__ldg(a.by + h + y)) * a.bw;
        const float vf = __int_as_float(__ldg(a.by + 2 * h + y));
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
            if (!kVec && p >= n) break;
            const int x0 = __ldg(a.bx + x + p), x1 = __ldg(a.bx + w + x + p);
            const float uf = __int_as_float(__ldg(a.bx + 2 * w + x + p));
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float* m = a.bloom[k];
                const float a00 = __ldg(m + r0 + x0), a10 = __ldg(m + r0 + x1);
                const float a01 = __ldg(m + r1 + x0), a11 = __ldg(m + r1 + x1);
                const float top = a00 + (a10 - a00) * uf;
                const float bot = a01 + (a11 - a01) * uf;
                c[k][p] = c[k][p] + (top + (bot - top) * vf);
            }
        }
    }
    uint32_t px[kPix][3];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
        const float r = c[0][p] * a.scale, g = c[1][p] * a.scale,
                    b = c[2][p] * a.scale;
        // ACES input matrix, fitted curve, output matrix
        const float ax = aces_fit(0.59719f * r + 0.35458f * g + 0.04823f * b);
        const float ay = aces_fit(0.07600f * r + 0.90834f * g + 0.01566f * b);
        const float az = aces_fit(0.02840f * r + 0.13383f * g + 0.83777f * b);
        const float o[3] = {
            clamp01(1.60475f * ax + -0.53108f * ay + -0.07367f * az),
            clamp01(-0.10208f * ax + 1.10813f * ay + -0.00605f * az),
            clamp01(-0.00327f * ax + -0.07276f * ay + 1.07602f * az)};
#pragma unroll
        for (int k = 0; k < 3; ++k)
            px[p][k] = encode_lut(o[k], a.lut);
    }
    uint8_t* dst = a.out + (static_cast<size_t>(a.h - 1 - y) * a.w + x) * 3;
    if (kVec) {
        // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3, little-endian words
        uint32_t* d = reinterpret_cast<uint32_t*>(dst);
        d[0] = px[0][0] | px[0][1] << 8 | px[0][2] << 16 | px[1][0] << 24;
        d[1] = px[1][1] | px[1][2] << 8 | px[2][0] << 16 | px[2][1] << 24;
        d[2] = px[2][2] | px[3][0] << 8 | px[3][1] << 16 | px[3][2] << 24;
    } else {
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
            if (p >= n) break;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                dst[3 * p + k] = static_cast<uint8_t>(px[p][k]);
        }
    }
}

template <bool kBloom, bool kVec>
cudaError_t launch(const TonemapArgs& a, cudaStream_t s) {
    const dim3 grid((a.w + kThreads * kPix - 1) / (kThreads * kPix), a.h);
    tonemap_rgb8_kernel<kBloom, kVec><<<grid, kThreads, 0, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

// The vector path needs 16-byte aligned planes and rows (w a multiple of
// 4) and 4-byte aligned output rows (which w a multiple of 4 gives).
extern "C" int ptrt_tonemap_rgb8(const TonemapArgs* args, void* stream) {
    const TonemapArgs& a = *args;
    if (a.h <= 0 || a.w <= 0) return static_cast<int>(cudaGetLastError());
    if (a.h > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool vec = a.w % kPix == 0 &&
               reinterpret_cast<uintptr_t>(a.out) % 4 == 0;
    for (int k = 0; k < 3; ++k)
        vec = vec && reinterpret_cast<uintptr_t>(a.hdr[k]) % 16 == 0;
    const bool bloom = a.bloom[0] != nullptr;
    const cudaError_t e =
        bloom ? (vec ? launch<true, true>(a, s) : launch<true, false>(a, s))
              : (vec ? launch<false, true>(a, s) : launch<false, false>(a, s));
    return static_cast<int>(e);
}

// Registers a thread and resident blocks a SM of K6's vector path (the
// 1080p frame's), ``bloom`` 0 without the bloom composite, 1 with it.
extern "C" int ptrt_tonemap_info(int bloom, int* regs, int* per_sm) {
    const void* fn =
        bloom ? reinterpret_cast<const void*>(tonemap_rgb8_kernel<true, true>)
              : reinterpret_cast<const void*>(tonemap_rgb8_kernel<false, true>);
    cudaFuncAttributes attr = {};
    cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn,
                                                          kThreads, 0);
    *regs = attr.numRegs;
    return static_cast<int>(e);
}
