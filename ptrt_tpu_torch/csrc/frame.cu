// K13: the frame's glue between the bounce loop and the post stack, as two
// kernels.
//
//   sample_sums          a sample's final clamp and its add into the
//                        frame's sums; at the last sample the 1 / spp scale
//                        and the persistent PCG state's advance
//   progressive_average  the progressive running average
//
// (K13's third part, the bounce loop's ray count, runs in shade_scatter's
// epilogue, csrc/shade.cu: it had a launch of its own here until its
// redesign.)
//
// Replaces (the reference computes each inside its jitted frame, XLA, no
// Pallas): ptrt_tpu/render/integrator.py :529 (the final soft clamp,
// core/vec.py clamp_vector_soft), ptrt_tpu/render/pipeline.py :119-168
// (the sample sums, the 1 / spp scale, prng.uniform of the frame's state)
// and ptrt_tpu/scene/pt_scene.py :950-958 (the progressive sum and average
// in _frame_fn).  The plain torch versions (render/pipeline.py
// sample_sums_plain, scene/pt_scene.py accumulate_plain) launch ~20
// kernels a sample and ~15 a progressive frame.
//
// What bounds them on the card: bytes.  sample_sums reads a sample's 3 (12
// split) radiance planes and, after sample 0, the sums, and writes the
// sums (at 1080p 25-100 MB a sample, 0.007-0.030 ms); the average reads
// the colour and the sum and writes the sum and the average (50 MB, 0.015
// ms).  A lane runs at most ~20 operations.
//
// What this design does about it: one launch each, one thread a pixel,
// nothing staged.  sample_sums keeps the sums in the frame's own planes
// across the samples' launches (a thread reads and writes only its own
// pixel).  progressive_average compares the 16 view-projection
// values and reads the keep flag and the count in every thread (broadcast
// loads), so nothing comes back to the host; one thread writes the new
// count into a tensor of its own.  The float operations follow the plain
// versions' order and roundings: the luminance's three products and two
// sums each rounded, the clamp's scale a true division of max_lum by a
// NaN-propagating max (torch's clamp_min), a sample added to the sums in
// sample order, the 1 / spp scale and the constants as torch passes a
// host number (rounded to float32), the average as a true reciprocal of
// the count and a product.  PCG runs in native uint32 and the state is
// written as the plain version's int64 plane holds it, in [0, 2^32).  This
// file builds with -fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>
#include <stdint.h>

struct SampleSumsArgs {
    const float* radiance[3];   // (n,) each: the sample's PathState.accum
    const float* part[9];       // split: diffuse, specular, emission (n,)
    float* sum[12];             // the colour's, then the parts': (n,) each
    int planes;                 // 3, or 12 when split
    int first, last;            // the sample is the frame's first / last
    float inv;                  // float32(1 / spp)
    float lum_w[3];             // the luminance's weights, as float32
    float max_lum, lum_floor;   // MAX_FINAL_RADIANCE, the divisor's floor
    const long long* rng;       // (h, w) PCG states, rows rng_pitch apart
    long long rng_pitch;
    long long* rng_out;         // (h, w) contiguous: the advanced states
    int h, w;
};

struct ProgressiveArgs {
    const float* color[3];      // (n,) each: the frame's colour
    const float* total[3];      // (n,) each: the sum so far, or null
    const float* count;         // 0-d: its count (with total)
    const float* view_proj;     // (16,): the frame's
    const float* vp;            // (16,): the sum's (with total)
    const void* keep;           // 0-d int32 / int64: 0 restarts, or null
    int keep_bytes;
    float* avg[3];              // (n,) each
    float* total_out[3];        // (n,) each
    float* count_out;           // 0-d
    long long n;
};

namespace {

constexpr int kBlockW = 32, kBlockH = 8;
constexpr int kAverageThreads = 256;

// torch.clamp_min against a number: a NaN operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// one plane of a sample's sums: the sample's value added to the sums in
// sample order (sample 0 starts them), scaled by 1 / spp at the last
__device__ __forceinline__ void add_sample(const SampleSumsArgs& a, int k,
                                           long long p, float v) {
    if (!a.first) v = a.sum[k][p] + v;
    if (a.last) v = v * a.inv;
    a.sum[k][p] = v;
}

__global__ void __launch_bounds__(kBlockW * kBlockH)
sample_sums_kernel(const SampleSumsArgs a) {
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y = blockIdx.y * kBlockH + threadIdx.y;
    if (x >= a.w || y >= a.h) return;
    const long long p = static_cast<long long>(y) * a.w + x;
    // vec.clamp_vector_soft(accum, MAX_FINAL_RADIANCE)
    const float rx = a.radiance[0][p], ry = a.radiance[1][p];
    const float rz = a.radiance[2][p];
    const float lum = (a.lum_w[0] * rx + a.lum_w[1] * ry) + a.lum_w[2] * rz;
    const float scale = (lum > a.max_lum && lum > 0.0f)
                            ? a.max_lum / tmax(lum, a.lum_floor)
                            : 1.0f;
    add_sample(a, 0, p, rx * scale);
    add_sample(a, 1, p, ry * scale);
    add_sample(a, 2, p, rz * scale);
    if (a.planes == 12) {
#pragma unroll
        for (int k = 0; k < 9; ++k) add_sample(a, 3 + k, p, a.part[k][p]);
    }
    if (a.last) {
        const unsigned s = static_cast<unsigned>(
            a.rng[static_cast<long long>(y) * a.rng_pitch + x]);
        a.rng_out[p] = static_cast<long long>(s * 747796405u + 2891336453u);
    }
}

__global__ void __launch_bounds__(kAverageThreads)
progressive_average_kernel(const ProgressiveArgs a) {
    const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    bool same = a.total[0] != nullptr;
    if (same) {
#pragma unroll
        for (int k = 0; k < 16; ++k) same = same && a.view_proj[k] == a.vp[k];
    }
    if (same && a.keep != nullptr) {
        const long long keep =
            a.keep_bytes == 8 ? *static_cast<const long long*>(a.keep)
                              : *static_cast<const int*>(a.keep);
        same = keep != 0;
    }
    const float count = same ? *a.count + 1.0f : 1.0f;
    if (p == 0) *a.count_out = count;
    if (p >= a.n) return;
    const float r = 1.0f / count;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float c = a.color[k][p];
        const float t = same ? a.total[k][p] + c : c;
        a.total_out[k][p] = t;
        a.avg[k][p] = t * r;
    }
}

}  // namespace

extern "C" int ptrt_sample_sums(const SampleSumsArgs* args, void* stream) {
    if (args->planes != 3 && args->planes != 12)
        return static_cast<int>(cudaErrorInvalidValue);
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const dim3 grid((args->w + kBlockW - 1) / kBlockW,
                    (args->h + kBlockH - 1) / kBlockH);
    sample_sums_kernel<<<grid, dim3(kBlockW, kBlockH), 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ptrt_progressive_average(const ProgressiveArgs* args,
                                        void* stream) {
    if (args->keep != nullptr && args->keep_bytes != 4 &&
        args->keep_bytes != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    // at least one block: the count is written also for an empty frame
    const long long blocks =
        args->n > 0 ? (args->n + kAverageThreads - 1) / kAverageThreads : 1;
    progressive_average_kernel<<<static_cast<unsigned>(blocks),
                                 kAverageThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}
