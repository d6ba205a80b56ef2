// K12 upscale_bilinear: the bilinear upscale of a frame's three colour
// planes to the display size.
//
// Replaces: ptrt_tpu/render/pipeline.py upscale_bilinear (:174-178), one
// jax.image.resize(..., "bilinear") a plane (XLA, no Pallas): rows first,
// then columns, each output sample the triangle-weighted pair of input
// samples at (j + 0.5) * in / out - 0.5, taps outside the input dropped
// and the rest renormalised.  The plain torch version (render/pipeline.py
// _resize_axis) launches ~45 kernels a plane and axis, 275 a frame.
//
// What bounds it on the card: bytes.  The source planes are read once and
// the output planes written once, 12 bytes an input and an output pixel:
// 39 MB from 1440x810 to 1920x1080, 0.0116 ms at 3.35 TB/s; under the
// launch floor at the games' 224x125 -> 640x360.  A pixel runs 18 float
// operations.
//
// What this design does about it: one launch for the three planes, one
// thread an output pixel (a 32 x 8 block), nothing staged: the four
// source texels of a pixel come through L1 and L2, where neighbouring
// output pixels share them.  The taps are the plain version's own: its
// tap indices and renormalised weights of each axis (render/pipeline.py
// resize_taps), made once for each (in, out) size and device and read
// here, so a frame captured into a CUDA graph builds nothing from host
// data.  The float operations follow the plain version's order: the row
// pass rounds each intermediate row value to float32 as the plain
// version's (out_h, in_w) plane holds it, a[r0] * w0 + a[r1] * w1, then
// the column pass combines two such values alike.  This file builds with
// -fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>

struct UpscaleArgs {
    const float* src[3];         // (in_h, in_w) each, contiguous
    float* dst[3];               // (out_h, out_w) each, contiguous
    const long long* row_index;  // (2, out_h): each output row's two taps
    const float* row_weight;     // (2, out_h): their weights
    const long long* col_index;  // (2, out_w)
    const float* col_weight;     // (2, out_w)
    int in_h, in_w, out_h, out_w;
};

namespace {

constexpr int kBlockW = 32, kBlockH = 8;

__global__ void __launch_bounds__(kBlockW * kBlockH)
upscale_bilinear_kernel(const UpscaleArgs a) {
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y = blockIdx.y * kBlockH + threadIdx.y;
    if (x >= a.out_w || y >= a.out_h) return;
    const long long r0 = a.row_index[y] * a.in_w;
    const long long r1 = a.row_index[a.out_h + y] * a.in_w;
    const float wr0 = a.row_weight[y], wr1 = a.row_weight[a.out_h + y];
    const long long c0 = a.col_index[x], c1 = a.col_index[a.out_w + x];
    const float wc0 = a.col_weight[x], wc1 = a.col_weight[a.out_w + x];
    const long long p = static_cast<long long>(y) * a.out_w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float* s = a.src[k];
        // the row pass at the two source columns, rounded as stored
        const float v0 = s[r0 + c0] * wr0 + s[r1 + c0] * wr1;
        const float v1 = s[r0 + c1] * wr0 + s[r1 + c1] * wr1;
        a.dst[k][p] = v0 * wc0 + v1 * wc1;
    }
}

}  // namespace

extern "C" int ptrt_upscale_bilinear(const UpscaleArgs* args, void* stream) {
    if (args->out_h <= 0 || args->out_w <= 0)
        return static_cast<int>(cudaGetLastError());
    if (args->in_h <= 0 || args->in_w <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((args->out_w + kBlockW - 1) / kBlockW,
                    (args->out_h + kBlockH - 1) / kBlockH);
    upscale_bilinear_kernel<<<grid, dim3(kBlockW, kBlockH), 0,
                              static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}
