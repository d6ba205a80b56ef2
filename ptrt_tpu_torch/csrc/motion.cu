// K7 motion_vectors: each pixel's uv motion against the previous frame.
//
// Replaces: ptrt_tpu/render/motion.py motion_vectors (:20): the pixel's
// pinhole ray (scene/camera.py pixel_grid :162 and get_ray_simple),
// its world point at the linear depth, that point projected through the
// previous frame's view-projection (core/mat.py project_point :199-207),
// and the difference of the two uvs; 0 where depth >= 1e29 or w <= 0.
// Under XLA a fusion; the plain torch version launches ~80 elementwise
// kernels over (H, W) planes.
//
// What bounds it on the card: bytes.  It reads the depth plane and writes
// two planes, 12 bytes a pixel: 24.9 MB, 0.0074 ms at 1080p at 3.35 TB/s;
// a pixel runs ~50 float operations.
//
// What this design does about it: one thread a pixel, nothing staged.  The
// camera's vectors and the 4x4 matrix are read through device pointers
// (broadcast loads, the same address for every thread), so a frame
// captured into a CUDA graph reads its own copies and nothing comes back
// to the host.  The float operations follow the plain version on the card:
// torch divides a tensor by a host number as a product with the number's
// rounded reciprocal, so s and t are (x + 0.5) * (1 / w); the direction is
// normalised by rsqrtf as torch.rsqrt is; the projection sums its terms
// left to right and 1 / w is a true division guarded at 1e-12.  This file
// builds with -fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>

struct MotionArgs {
    const float* depth;          // (h, w)
    const float* origin[3];      // the camera's 0-d float32 values
    const float* llc[3];
    const float* horizontal[3];
    const float* vertical[3];
    const float* view_proj;      // (4, 4) row-major: the previous frame's
    float* mx;                   // (h, w) each
    float* my;
    int h, w;
    float sky_depth;             // motion.SKY_DEPTH_THRESHOLD
};

namespace {

constexpr int kBlockW = 32, kBlockH = 8;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 at(const float* const p[3]) {
    return V3{*p[0], *p[1], *p[2]};
}

__global__ void __launch_bounds__(kBlockW * kBlockH)
motion_vectors_kernel(const MotionArgs a) {
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y = blockIdx.y * kBlockH + threadIdx.y;
    if (x >= a.w || y >= a.h) return;
    const int p = y * a.w + x;
    const float s = (static_cast<float>(x) + 0.5f) *
                    (1.0f / static_cast<float>(a.w));
    const float t = (static_cast<float>(y) + 0.5f) *
                    (1.0f / static_cast<float>(a.h));
    const V3 o = at(a.origin), llc = at(a.llc);
    const V3 hz = at(a.horizontal), vt = at(a.vertical);
    float dx = ((llc.x + hz.x * s) + vt.x * t) - o.x;
    float dy = ((llc.y + hz.y * s) + vt.y * t) - o.y;
    float dz = ((llc.z + hz.z * s) + vt.z * t) - o.z;
    const float r = rsqrtf((dx * dx + dy * dy) + dz * dz);
    dx = dx * r;
    dy = dy * r;
    dz = dz * r;
    const float depth = a.depth[p];
    const float px = o.x + dx * depth;
    const float py = o.y + dy * depth;
    const float pz = o.z + dz * depth;
    const float* m = a.view_proj;
    const float cx = ((m[0] * px + m[1] * py) + m[2] * pz) + m[3];
    const float cy = ((m[4] * px + m[5] * py) + m[6] * pz) + m[7];
    const float cw = ((m[12] * px + m[13] * py) + m[14] * pz) + m[15];
    const float inv_w = 1.0f / (fabsf(cw) < 1e-12f ? 1e-12f : cw);
    const float mx = s - ((cx * inv_w) * 0.5f + 0.5f);
    const float my = t - ((cy * inv_w) * 0.5f + 0.5f);
    const bool valid = depth < a.sky_depth && cw > 0.0f;
    a.mx[p] = valid ? mx : 0.0f;
    a.my[p] = valid ? my : 0.0f;
}

}  // namespace

extern "C" int ptrt_motion_vectors(const MotionArgs* args, void* stream) {
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const dim3 grid((args->w + kBlockW - 1) / kBlockW,
                    (args->h + kBlockH - 1) / kBlockH);
    motion_vectors_kernel<<<grid, dim3(kBlockW, kBlockH), 0,
                            static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}
