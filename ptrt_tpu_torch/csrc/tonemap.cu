// K6 tonemap_rgb8: HDR -> display uint8 in one pass.
//
// Replaces: ptrt_tpu/render/pipeline.py:tonemap_to_rgb8, i.e. the XLA
// fusion of core/color.py:aces_tonemap, srgb_oetf and to_rgb8 plus the
// Y-flip.
//
// What bounds it on the card: memory traffic.  Per pixel it reads 12 bytes
// (three float planes) and writes 3 bytes; the arithmetic (two 3x3
// matrices, one rational fit and a powf per channel) is small beside that.
// A 1920x1080 frame moves about 31 MB, ~10 us at the H100's 3.35 TB/s.
//
// What this design does about it: one thread per pixel, coalesced loads
// of the three SoA planes, every intermediate kept in registers (the plain
// torch version writes each of its ~60 intermediates to device memory), and
// the flipped interleaved RGB written directly.  The exact sRGB OETF keeps
// powf (no fast-math); constants are the float32 roundings of the
// reference's Python literals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clamp01(float v) {
    return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ __forceinline__ float aces_fit(float ac) {
    const float a = ac * (ac + 0.0245786f) - 0.000090537f;
    const float b = ac * (ac * 0.983729f + 0.4329510f) + 0.238081f;
    return clamp01(a / b);
}

__device__ __forceinline__ uint8_t encode(float v) {
    v = fmaxf(v, 0.0f);
    v = v <= 0.0031308f ? 12.92f * v
                        : 1.055f * powf(v, 0.41666666666666667f) - 0.055f;
    const float q = fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f);
    return static_cast<uint8_t>(__float2uint_rz(q));
}

__global__ void __launch_bounds__(kThreads)
tonemap_rgb8_kernel(const float* __restrict__ r, const float* __restrict__ g,
                    const float* __restrict__ b, int h, int w, float scale,
                    uint8_t* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= h * w) return;
    const float x = r[i] * scale, y = g[i] * scale, z = b[i] * scale;
    // ACES input matrix, fitted curve, output matrix
    const float ax = aces_fit(0.59719f * x + 0.35458f * y + 0.04823f * z);
    const float ay = aces_fit(0.07600f * x + 0.90834f * y + 0.01566f * z);
    const float az = aces_fit(0.02840f * x + 0.13383f * y + 0.83777f * z);
    const float ox = clamp01(1.60475f * ax + -0.53108f * ay + -0.07367f * az);
    const float oy = clamp01(-0.10208f * ax + 1.10813f * ay + -0.00605f * az);
    const float oz = clamp01(-0.00327f * ax + -0.07276f * ay + 1.07602f * az);
    const int py = i / w, px = i - py * w;
    uint8_t* dst = out + (static_cast<size_t>(h - 1 - py) * w + px) * 3;
    dst[0] = encode(ox);
    dst[1] = encode(oy);
    dst[2] = encode(oz);
}

}  // namespace

extern "C" int ptrt_tonemap_rgb8(const float* r, const float* g,
                                 const float* b, int h, int w, float scale,
                                 uint8_t* out, void* stream) {
    const int n = h * w;
    if (n > 0) {
        tonemap_rgb8_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
            r, g, b, h, w, scale, out);
    }
    return static_cast<int>(cudaGetLastError());
}
