// bloom_blur_down: one mip step of the bloom chain — the 5-tap horizontal
// Gaussian with edge clamp, then the vertical 5-tap Gaussian fused with the
// 2x decimation, from an (h, w) image to (h / 2, ceil(w / 2)).
//
// Replaces: ptrt_tpu/render/bloom.py _downsample_v(_blur_h(img)) (:30-62),
// the per-mip body of apply_bloom (:100-106).  The reference decimates rows
// to h // 2 (rows 2y) and columns with [:, ::2] (columns 2x, ceil(w / 2) of
// them); at 1080p the mip heights run 540, 270, 135, 67, 33, 16.
//
// What bounds it on the card: memory traffic.  Each output pixel needs 5
// rows x 5 columns of the input per channel; the plain torch version writes
// the full-resolution horizontal blur and ten shifted copies to device
// memory before decimating.
//
// What this design does about it: one thread per output pixel computes the
// horizontal blur only at the five rows and the one column it keeps, in
// registers; the 25 loads per channel come from L1/L2, which the threads of
// a block share.  Input is read once from device memory, output written
// once.  The float operations follow the plain version's order; this file
// builds with -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32, kBlockY = 8;
constexpr float kW0 = 0.227027f, kW1 = 0.316216f, kW2 = 0.070270f;

__device__ __forceinline__ float blur_h(const float* __restrict__ row, int c,
                                        int w) {
    const float l1 = row[max(c - 1, 0)], r1 = row[min(c + 1, w - 1)];
    const float l2 = row[max(c - 2, 0)], r2 = row[min(c + 2, w - 1)];
    float out = row[c] * kW0;
    out = out + (l1 + r1) * kW1;
    return out + (l2 + r2) * kW2;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
bloom_blur_down_kernel(const float* __restrict__ in0,
                       const float* __restrict__ in1,
                       const float* __restrict__ in2, int h, int w,
                       float* __restrict__ out0, float* __restrict__ out1,
                       float* __restrict__ out2, int oh, int ow) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= ow || y >= oh) return;
    const int cx = 2 * x;
    const float* in[3] = {in0, in1, in2};
    float* out[3] = {out0, out1, out2};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float acc = 0.0f;
#pragma unroll
        for (int j = -2; j <= 2; ++j) {
            const int r = min(max(2 * y + j, 0), h - 1);
            const float wj = j == 0 ? kW0 : (j == 1 || j == -1 ? kW1 : kW2);
            const float term = blur_h(in[k] + static_cast<long long>(r) * w,
                                      cx, w) * wj;
            acc = j == -2 ? term : acc + term;
        }
        out[k][y * ow + x] = acc;
    }
}

}  // namespace

extern "C" int ptrt_bloom_blur_down(const float* in0, const float* in1,
                                    const float* in2, int h, int w,
                                    float* out0, float* out1, float* out2,
                                    void* stream) {
    const int oh = h / 2, ow = (w + 1) / 2;
    if (oh > 0 && ow > 0) {
        const dim3 grid((ow + kBlockX - 1) / kBlockX,
                        (oh + kBlockY - 1) / kBlockY);
        bloom_blur_down_kernel<<<grid, dim3(kBlockX, kBlockY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
            in0, in1, in2, h, w, out0, out1, out2, oh, ow);
    }
    return static_cast<int>(cudaGetLastError());
}
