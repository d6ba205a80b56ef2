// K0 camera_rays: one sample's jittered primary rays, each with its own PCG
// sub-stream.  camera_make (after K0 below): a camera's every value from
// its host inputs.
//
// Replaces: the camera-ray part of ptrt_tpu/render/pipeline.py trace_batch
// (:92-109): the TAA jitter (core/taa.py taa_jitter :39, the 16-entry
// Halton table at (frame + sample) mod 16), the blue-noise pair
// (core/bluenoise.py next_blue_noise :68-107: the (64, 64, 2) table at the
// global pixel, rotated by the frame's 32-bit golden-ratio hash), the
// camera uv, prng.fold(state, sample + 1) (core/rng.py :51) and
// Camera.get_ray (scene/camera.py :98: a unit-disk sample of two PCG
// draws, the lens offset times 0 or 1, the direction normalised).  Under
// XLA a fusion; the plain torch version launches ~100 kernels a sample,
// ~48 of them on 0-d values when the frame index lies on the card.
//
// What bounds it on the card: bytes.  A pixel reads its PCG state (8
// bytes) and writes the sub-stream's state (8), the origin and direction
// (24) and the spec flag (1): 85 MB, 0.025 ms a 1080p sample at 3.35 TB/s.
// A pixel runs ~90 operations (PCG, sqrtf, cosf, sinf, rsqrtf).
//
// What this design does about it: one thread a pixel, nothing staged; the
// camera's vectors and the lens radius are read through device pointers,
// as is the frame index when it lies on the card (a frame captured into a
// CUDA graph reads its staged index; a host index is an argument), so
// nothing comes back to the host.  It writes flat contiguous planes that
// PathState.start takes without copying.  PCG runs in native uint32 and
// the state is written as the plain version's int64 planes hold it, in
// [0, 2^32).  The float operations follow the plain version on the card:
// torch divides a tensor by a host number as a product with the number's
// rounded reciprocal, so the uv is (x + 0.5 + jitter) * (1 / full_w); the
// direction is normalised by rsqrtf as torch.rsqrt is.  This file builds
// with -fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>
#include <stdint.h>

struct CameraRaysArgs {
    const long long* rng;        // (h, w) PCG states, rows rng_pitch apart
    long long rng_pitch;
    const float* blue_noise;     // (64, 64, 2)
    const float* halton;         // (16, 2): taa.halton_table
    const void* frame;           // 0-d int32 or int64 on the card, or null
    long long frame_host;        // the frame index when frame is null
    int frame_bytes;             // 4 or 8
    int sample;
    unsigned int salt;           // (sample + 1) * 0x9E3779B9 mod 2^32
    const float* origin[3];      // the camera's 0-d float32 values
    const float* llc[3];
    const float* horizontal[3];
    const float* vertical[3];
    const float* u[3];
    const float* v[3];
    const float* lens_radius;
    long long* sub;              // (h, w) each, contiguous
    float* o[3];
    float* d[3];
    unsigned char* spec;
    int h, w;
    int y0, x0, full_h, full_w;  // the tile's place in its frame
};

namespace {

constexpr int kBlockW = 32, kBlockH = 8;
constexpr int kBlueNoise = 64;
constexpr int kTaaLength = 16;

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 at(const float* const p[3]) {
    return V3{*p[0], *p[1], *p[2]};
}

// one PCG step (core/rng.py uniform): the new state, and its float32 in
// [0, 1)
__device__ __forceinline__ uint32_t pcg(uint32_t& state) {
    state = state * 747796405u + 2891336453u;
    uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
    return (word >> 22) ^ word;
}
__device__ __forceinline__ float pcg_uniform(uint32_t& state) {
    return static_cast<float>(pcg(state)) * 2.3283064365386963e-10f;
}

// the frame's Cranley-Patterson shifts (core/bluenoise.py _rotation)
__device__ __forceinline__ void rotation(long long frame, float& sx,
                                         float& sy) {
    uint32_t h = static_cast<uint32_t>(frame);
    h *= 0x9E3779B9u;
    h ^= h >> 15;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    sx = static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
    h *= 0x85EBCA6Bu;
    sy = static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(kBlockW * kBlockH)
camera_rays_kernel(const CameraRaysArgs a) {
    const int x = blockIdx.x * kBlockW + threadIdx.x;
    const int y = blockIdx.y * kBlockH + threadIdx.y;
    if (x >= a.w || y >= a.h) return;
    const int p = y * a.w + x;
    const int gx = x + a.x0, gy = y + a.y0;

    // the frame index + sample: an int32 index adds in int32, as torch
    long long f;
    if (a.frame == nullptr) {
        f = a.frame_host + a.sample;
    } else if (a.frame_bytes == 8) {
        f = *static_cast<const long long*>(a.frame) + a.sample;
    } else {
        f = static_cast<int>(
            static_cast<uint32_t>(*static_cast<const int*>(a.frame)) +
            static_cast<uint32_t>(a.sample));
    }
    const int k = static_cast<int>(((f % kTaaLength) + kTaaLength) % kTaaLength);
    const float jx = a.halton[2 * k] - 0.5f;
    const float jy = a.halton[2 * k + 1] - 0.5f;
    float shift_x, shift_y;
    rotation(f, shift_x, shift_y);
    const int cell = ((gy & (kBlueNoise - 1)) * kBlueNoise +
                      (gx & (kBlueNoise - 1))) * 2;
    float bu = a.blue_noise[cell] + shift_x;
    float bv = a.blue_noise[cell + 1] + shift_y;
    bu = bu >= 1.0f ? bu - 1.0f : bu;
    bv = bv >= 1.0f ? bv - 1.0f : bv;
    const float jitter_x = jx + (bu - 0.5f) * 0.25f;
    const float jitter_y = jy + (bv - 0.5f) * 0.25f;
    const float sg = ((static_cast<float>(gx) + 0.5f) + jitter_x) *
                     (1.0f / static_cast<float>(a.full_w));
    const float tg = ((static_cast<float>(gy) + 0.5f) + jitter_y) *
                     (1.0f / static_cast<float>(a.full_h));

    // fold(state, sample + 1), then the unit-disk sample's two draws
    uint32_t state = static_cast<uint32_t>(a.rng[y * a.rng_pitch + x]) ^ a.salt;
    pcg(state);
    const float u1 = pcg_uniform(state);
    const float u2 = pcg_uniform(state);
    const float r = sqrtf(u1);
    const float phi = 6.283185307179586f * u2;
    const float lr = *a.lens_radius;
    const float rdx = (r * cosf(phi)) * lr;
    const float rdy = (r * sinf(phi)) * lr;
    const V3 cu = at(a.u), cv = at(a.v);
    const float dof = lr > 0.0f ? 1.0f : 0.0f;
    const float ox = (cu.x * rdx + cv.x * rdy) * dof;
    const float oy = (cu.y * rdx + cv.y * rdy) * dof;
    const float oz = (cu.z * rdx + cv.z * rdy) * dof;
    const V3 o = at(a.origin), llc = at(a.llc);
    const V3 hz = at(a.horizontal), vt = at(a.vertical);
    float dx = (((llc.x + hz.x * sg) + vt.x * tg) - o.x) - ox;
    float dy = (((llc.y + hz.y * sg) + vt.y * tg) - o.y) - oy;
    float dz = (((llc.z + hz.z * sg) + vt.z * tg) - o.z) - oz;
    const float rl = rsqrtf((dx * dx + dy * dy) + dz * dz);
    dx = dx * rl;
    dy = dy * rl;
    dz = dz * rl;

    a.sub[p] = static_cast<long long>(state);
    a.o[0][p] = o.x + ox;
    a.o[1][p] = o.y + oy;
    a.o[2][p] = o.z + oz;
    a.d[0][p] = dx;
    a.d[1][p] = dy;
    a.d[2][p] = dz;
    a.spec[p] = 1;
}

}  // namespace

extern "C" int ptrt_camera_rays(const CameraRaysArgs* args, void* stream) {
    if (args->frame != nullptr && args->frame_bytes != 4 &&
        args->frame_bytes != 8)
        return static_cast<int>(cudaErrorInvalidValue);
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const dim3 grid((args->w + kBlockW - 1) / kBlockW,
                    (args->h + kBlockH - 1) / kBlockH);
    camera_rays_kernel<<<grid, dim3(kBlockW, kBlockH), 0,
                         static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

// camera_make: every value of a Camera (scene/camera.py) from its 15 host
// inputs, staged on the card.
//
// Replaces no TPU kernel: it is Camera.make (scene/camera.py), ~100 torch
// ops on 0-d tensors (m4.look_at, m4.perspective, proj @ view and
// linalg.inv_ex among them), each an eager launch from the host.  In a
// frame program it is the first kernel of the replay, reading the inputs
// the program staged with its frame index (graphs.HostValues), so a camera
// move costs the host the staging of 15 floats and the card one launch;
// a camera read on the host (Scene.camera) is one launch too.
//
// What bounds it on the card: latency.  One thread reads 60 bytes and
// writes 296 in ~300 float and ~150 double operations, a few microseconds
// of one SM.
//
// What this design does about it: one thread, nothing staged; the inputs
// and each output are read and written through device pointers, so it is
// captured into a CUDA graph as it is launched.  Every value but
// inv_view_proj is Camera.make's on the card bit for bit: each operation
// in Camera.make's order, one rounding each (this file builds with
// -fmad=false), the division by a host number a product with its
// reciprocal as torch computes it, tanf and rsqrtf as torch's tan and
// rsqrt call them, the clip terms in double as Python computes them and
// rounded once.  inv_view_proj (which nothing in a frame reads) inverts
// the product proj @ view, accumulated as cuBLAS does (fused multiply-adds,
// k ascending: its bits on the card), in double: within a float32 rounding
// of the product's exact inverse.  torch's linalg.inv_ex, an LU in float32,
// lies up to ~1e-4 of the matrix's largest value from it for these
// matrices (condition numbers to ~5e4), and no float32 order of operations
// tried gave its bits, so this value is nearer the exact inverse than
// torch's and not equal to it.

struct CameraMakeArgs {
    // lookfrom, lookat, vup (3 each), fov (degrees), aspect, focus_dist,
    // aperture, znear, zfar: 0-d float32 on the card
    const float* in[15];
    float* view;           // (4, 4) row-major, each
    float* proj;
    float* inv_view_proj;
    float* origin;         // 3 consecutive floats, each
    float* lower_left_corner;
    float* horizontal;
    float* vertical;
    float* u;
    float* v;
    float* w;
    float* lens_radius;    // 1 float, each
    float* fov;
    float* aspect;
    float* near_clip;
    float* far_clip;
};

namespace {

__device__ __forceinline__ V3 sub3(V3 a, V3 b) {
    return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale3(V3 a, float s) {
    return V3{a.x * s, a.y * s, a.z * s};
}
// (a.x * b.x + a.y * b.y) + a.z * b.z, each product rounded
__device__ __forceinline__ float dot3(V3 a, V3 b) {
    return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}
// Vec3.normalized(): a * rsqrt(|a|^2 + 0); the sum is never -0
__device__ __forceinline__ V3 normalize3(V3 a) {
    return scale3(a, rsqrtf(dot3(a, a)));
}
__device__ __forceinline__ void put3(float* p, V3 a) {
    p[0] = a.x;
    p[1] = a.y;
    p[2] = a.z;
}

// the inverse of m (row-major 4x4) into inv: LU with partial pivoting (the
// first largest magnitude) and back substitution in double, each value
// rounded to float32 once
__device__ void inverse4(const float m[16], float* inv) {
    double a[4][4], x[4][4];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            a[i][j] = m[4 * i + j];
            x[i][j] = i == j ? 1.0 : 0.0;
        }
    for (int j = 0; j < 4; ++j) {
        int p = j;
        for (int i = j + 1; i < 4; ++i)
            if (fabs(a[i][j]) > fabs(a[p][j])) p = i;
        for (int k = 0; k < 4; ++k) {
            double t = a[j][k];
            a[j][k] = a[p][k];
            a[p][k] = t;
            t = x[j][k];
            x[j][k] = x[p][k];
            x[p][k] = t;
        }
        for (int i = j + 1; i < 4; ++i) {
            const double l = a[i][j] / a[j][j];
            for (int k = j; k < 4; ++k) a[i][k] -= l * a[j][k];
            for (int k = 0; k < 4; ++k) x[i][k] -= l * x[j][k];
        }
    }
    for (int i = 3; i >= 0; --i)
        for (int c = 0; c < 4; ++c) {
            double s = x[i][c];
            for (int k = i + 1; k < 4; ++k) s -= a[i][k] * x[k][c];
            x[i][c] = s / a[i][i];
        }
    for (int i = 0; i < 4; ++i)
        for (int c = 0; c < 4; ++c)
            inv[4 * i + c] = static_cast<float>(x[i][c]);
}

__global__ void __launch_bounds__(1) camera_make_kernel(const CameraMakeArgs a) {
    const V3 from{*a.in[0], *a.in[1], *a.in[2]};
    const V3 target{*a.in[3], *a.in[4], *a.in[5]};
    const V3 up{*a.in[6], *a.in[7], *a.in[8]};
    const float fov = *a.in[9], aspect = *a.in[10], focus = *a.in[11];
    const float aperture = *a.in[12], znear = *a.in[13], zfar = *a.in[14];

    // the basis (Camera.make): theta = fov * float32(pi / 180), h =
    // tan(theta / 2) (a division by 2.0: the product with 0.5)
    const float theta = fov * static_cast<float>(3.141592653589793 / 180.0);
    const float h = tanf(theta * 0.5f);
    const float vh = h * 2.0f;
    const float vw = aspect * vh;
    const V3 w = normalize3(sub3(from, target));
    const V3 u = normalize3(cross3(up, w));
    const V3 v = cross3(w, u);
    const V3 hz = scale3(u, focus * vw);
    const V3 vt = scale3(v, focus * vh);
    const V3 llc = sub3(sub3(sub3(from, scale3(hz, 0.5f)), scale3(vt, 0.5f)),
                        scale3(w, focus));

    // m4.look_at(lookfrom, lookat, vup)
    const V3 f = normalize3(sub3(target, from));
    const V3 s = normalize3(cross3(f, up));
    const V3 uu = cross3(s, f);
    const float view[16] = {
        s.x, s.y, s.z, -dot3(s, from),
        uu.x, uu.y, uu.z, -dot3(uu, from),
        -f.x, -f.y, -f.z, dot3(f, from),
        0.0f, 0.0f, 0.0f, 1.0f};

    // m4.perspective(theta, aspect, znear, zfar): f = 1 / tan(theta / 2);
    // the clip terms from the clip planes in double, rounded once
    const float fp = 1.0f / h;
    const double zn = znear, zf = zfar;
    float proj[16] = {};
    proj[0] = fp / aspect;
    proj[5] = fp;
    proj[10] = static_cast<float>((zf + zn) / (zn - zf));
    proj[11] = static_cast<float>((2.0 * zf * zn) / (zn - zf));
    proj[14] = -1.0f;

    float vp[16];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) {
            float acc = 0.0f;
            for (int k = 0; k < 4; ++k)
                acc = fmaf(proj[4 * i + k], view[4 * k + j], acc);
            vp[4 * i + j] = acc;
        }
    inverse4(vp, a.inv_view_proj);
    for (int k = 0; k < 16; ++k) {
        a.view[k] = view[k];
        a.proj[k] = proj[k];
    }
    put3(a.origin, from);
    put3(a.lower_left_corner, llc);
    put3(a.horizontal, hz);
    put3(a.vertical, vt);
    put3(a.u, u);
    put3(a.v, v);
    put3(a.w, w);
    *a.lens_radius = aperture * 0.5f;
    *a.fov = fov;
    *a.aspect = aspect;
    *a.near_clip = znear;
    *a.far_clip = zfar;
}

}  // namespace

extern "C" int ptrt_camera_make(const CameraMakeArgs* args, void* stream) {
    camera_make_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*args);
    return static_cast<int>(cudaGetLastError());
}
