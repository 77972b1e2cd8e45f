// Per-ray BVH traversal for NVIDIA GPUs, called from JAX through the XLA
// foreign function interface (raytracingrenderer_tpu/ops/traverse.py).
//
// One thread walks one ray down the binary BVH with a private stack,
// visiting the nearer child first and skipping stacked subtrees whose
// entry distance is already beyond the closest hit.  The any-hit variant
// stops at the first occluder.
//
// Tables (packed in JAX by ops/traverse.py, read through the read-only
// cache with 16-byte loads):
//   nodes (B, 16) f32: row i of an inner node holds both children:
//     [lo_l.xyz, hi_l.xyz, lo_r.xyz, hi_r.xyz, code_l, code_r, 0, 0]
//     where a child code >= 0 is the child's own row and a code < 0 is a
//     leaf, -(1 + (start << 4 | count)).  Row 0 is the root.
//   tris (T, 12) f32: [p0.xyz, 0, e1.xyz, 0, e2.xyz, 0].
// Rays arrive as seven (N,) arrays: origin, direction and the search
// radius t_max (<= 0 marks an inactive ray).  The arithmetic follows
// geometry/intersect.py (_slab, _mt_test) operation for operation and is
// compiled without FMA contraction (native/Makefile), so it rounds like
// XLA's.
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxStack = 64;   // ops/traverse.py MAX_STACK
constexpr int kBlock = 128;     // ops/traverse.py BLOCK
constexpr float kDetEps = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

// Ray-box slab test; returns the entry distance in *t_entry.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float t_best, float* t_entry) {
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  const float tmin = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fminf(t0z, t1z));
  const float tmax = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fmaxf(t0z, t1z));
  *t_entry = tmin;
  return tmax >= fmaxf(tmin, 0.0f) && tmin < t_best;
}

// Moller-Trumbore; true on a hit nearer than t_best.
__device__ __forceinline__ bool mt(const Ray& r, const float4* tri,
                                   float t_best, float* t_out, float* u_out,
                                   float* v_out) {
  const float4 p0 = __ldg(tri), e1 = __ldg(tri + 1), e2 = __ldg(tri + 2);
  const float px = r.dy * e2.z - r.dz * e2.y;
  const float py = r.dz * e2.x - r.dx * e2.z;
  const float pz = r.dx * e2.y - r.dy * e2.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const bool bad = fabsf(det) < kDetEps;
  const float inv_det = bad ? 0.0f : 1.0f / det;
  const float tx = r.ox - p0.x, ty = r.oy - p0.y, tz = r.oz - p0.z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
  if (!bad && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f &&
      t < t_best) {
    *t_out = t;
    *u_out = u;
    *v_out = v;
    return true;
  }
  return false;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse_kernel(const float4* __restrict__ nodes,
                    const float4* __restrict__ tris,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_max, int64_t n,
                    float* __restrict__ t_out, int32_t* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  float t_best = t_max[i], hit_u = 0.0f, hit_v = 0.0f;
  int32_t hit_tri = -1;

  if (t_best > 0.0f) {
    int32_t stack[kMaxStack];
    float stack_t[kMaxStack];
    int sp = 0;
    int32_t code = 0;
    while (true) {
      if (code >= 0) {
        const float4* row = nodes + 4 * static_cast<int64_t>(code);
        const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
        const float4 e = __ldg(row + 3);
        float tl, tr;
        const bool hl = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, t_best, &tl);
        const bool hr = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, t_best, &tr);
        int32_t cl = __float_as_int(e.x), cr = __float_as_int(e.y);
        if (hl && hr) {
          if (tr < tl) {
            const int32_t ct = cl; cl = cr; cr = ct;
            const float tt = tl; tl = tr; tr = tt;
          }
          stack[sp] = cr;
          stack_t[sp] = tr;
          ++sp;
          code = cl;
          continue;
        }
        if (hl) { code = cl; continue; }
        if (hr) { code = cr; continue; }
      } else {
        const int32_t leaf = -code - 1;
        const int32_t start = leaf >> 4, count = leaf & 15;
        bool found = false;
        for (int32_t k = 0; k < count; ++k) {
          float t, u, v;
          if (mt(r, tris + 3 * static_cast<int64_t>(start + k), t_best, &t,
                 &u, &v)) {
            t_best = t; hit_u = u; hit_v = v; hit_tri = start + k;
            found = true;
            if (kAnyHit) break;
          }
        }
        if (kAnyHit && found) break;
      }
      // pop the nearest pending subtree still in front of the best hit
      bool more = false;
      while (sp > 0) {
        --sp;
        if (stack_t[sp] < t_best) { code = stack[sp]; more = true; break; }
      }
      if (!more) break;
    }
  }
  t_out[i] = t_best;
  tri_out[i] = hit_tri;
  u_out[i] = hit_u;
  v_out[i] = hit_v;
}

template <bool kAnyHit>
ffi::Error Traverse(cudaStream_t stream, ffi::Buffer<ffi::F32> nodes,
                    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                    ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                    ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                    ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> t_max,
                    ffi::ResultBuffer<ffi::F32> t_out,
                    ffi::ResultBuffer<ffi::S32> tri_out,
                    ffi::ResultBuffer<ffi::F32> u_out,
                    ffi::ResultBuffer<ffi::F32> v_out) {
  const int64_t n = ox.element_count();
  if (n == 0) return ffi::Error::Success();
  const int64_t grid = (n + kBlock - 1) / kBlock;
  traverse_kernel<kAnyHit><<<grid, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes.typed_data()),
      reinterpret_cast<const float4*>(tris.typed_data()), ox.typed_data(),
      oy.typed_data(), oz.typed_data(), dx.typed_data(), dy.typed_data(),
      dz.typed_data(), t_max.typed_data(), n, t_out->typed_data(),
      tri_out->typed_data(), u_out->typed_data(), v_out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error(ffi::ErrorCode::kInternal, cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error ClosestHit(cudaStream_t s, ffi::Buffer<ffi::F32> nodes,
                      ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                      ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                      ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                      ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> t_max,
                      ffi::ResultBuffer<ffi::F32> t,
                      ffi::ResultBuffer<ffi::S32> tri,
                      ffi::ResultBuffer<ffi::F32> u,
                      ffi::ResultBuffer<ffi::F32> v) {
  return Traverse<false>(s, nodes, tris, ox, oy, oz, dx, dy, dz, t_max, t,
                         tri, u, v);
}

ffi::Error AnyHit(cudaStream_t s, ffi::Buffer<ffi::F32> nodes,
                  ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> ox,
                  ffi::Buffer<ffi::F32> oy, ffi::Buffer<ffi::F32> oz,
                  ffi::Buffer<ffi::F32> dx, ffi::Buffer<ffi::F32> dy,
                  ffi::Buffer<ffi::F32> dz, ffi::Buffer<ffi::F32> t_max,
                  ffi::ResultBuffer<ffi::F32> t,
                  ffi::ResultBuffer<ffi::S32> tri,
                  ffi::ResultBuffer<ffi::F32> u,
                  ffi::ResultBuffer<ffi::F32> v) {
  return Traverse<true>(s, nodes, tris, ox, oy, oz, dx, dy, dz, t_max, t,
                        tri, u, v);
}

}  // namespace

#define RT_BINDING                                       \
  ffi::Ffi::Bind()                                       \
      .Ctx<ffi::PlatformStream<cudaStream_t>>()          \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Arg<ffi::Buffer<ffi::F32>>()                      \
      .Ret<ffi::Buffer<ffi::F32>>()                      \
      .Ret<ffi::Buffer<ffi::S32>>()                      \
      .Ret<ffi::Buffer<ffi::F32>>()                      \
      .Ret<ffi::Buffer<ffi::F32>>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(RtClosestHit, ClosestHit, RT_BINDING);
XLA_FFI_DEFINE_HANDLER_SYMBOL(RtAnyHit, AnyHit, RT_BINDING);
