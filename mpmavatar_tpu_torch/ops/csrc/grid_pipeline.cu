// K5: fused grid pipeline — one pass per grid cell: momentum -> velocity
// + gravity*dt (+ damping), body-mesh projection with Coulomb friction,
// mover override, sticky/slip/frictional surface BCs within [t0, t1), and
// bounding-box zeroing.
//
// Replaces: mpmavatar_tpu/ops/pallas_grid_pipeline.py::_grid_pipeline_pallas
// (built by make_grid_pipeline, math in _make_math).  Plain PyTorch twin:
// ops/grid_pipeline.py::grid_pipeline_plain.
//
// Bound on an H100: memory.  Without mesh and mover fields every cell
// reads grid_m (4 B) and writes 12 B; only an active cell (grid_m > 1e-15)
// reads its 12 B of grid_v.  A cloth fills few of the 2.1 M cells at
// G = 128, so ~16 B per cell, ~34 MB, ~10 us at 3.35 TB/s (chip_smoke.py
// counts the active cells of its run); the arithmetic is a few dozen FP32
// operations per cell.  Design: one thread per cell, cell
// coordinates rebuilt from the flat id (x-major); the scene's scalars
// each come from a pointer, so a caller passes its tensors unpacked:
//   gravity(3), damping(1), mesh_friction(1) (read only with a mesh),
//   surf = per surface: point(3), normal(3), friction, t0, t1
// surface types 2 bits each in surf_types (STICKY 0, SLIP 1, FRICTIONAL 2).
// The mesh and mover branches run only when their fields are passed.
// The launch covers n_cells cells from flat cell cell0 on (the whole grid
// from 0, or a rank's slab of it): every array is indexed by the cell's
// row, the coordinates come from its flat index cell0 + row.
// The time comes by value, or from a float32 device scalar where time_p is
// not null (a captured substep, whose clock advances on the device).

#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-15f;

__global__ void grid_pipeline_kernel(
    const float* __restrict__ gv, const float* __restrict__ gm,
    const float* __restrict__ mesh_acc, const float* __restrict__ mesh_w,
    const float* __restrict__ mover_v, const float* __restrict__ mover_w,
    const float* __restrict__ gravity, const float* __restrict__ damping_p,
    const float* __restrict__ mesh_friction, const float* __restrict__ surf,
    float time_v, float dt, const float* __restrict__ time_p, int cell0,
    int n_cells, int G, float cell_size, int has_mesh, int has_mover,
    int n_surf, int surf_types, int has_bbox, int bbox_pad,
    float* __restrict__ out) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n_cells) return;
  const float time = time_p != nullptr ? *time_p : time_v;
  const int flat = cell0 + cell;
  const int gi[3] = {flat / (G * G), (flat / G) % G, flat % G};
  const float damping = *damping_p;

  const float m = gm[cell];
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (m > kEps)  // an empty cell reads no grid_v
    for (int c = 0; c < 3; ++c) v[c] = gv[3 * cell + c] / m + dt * gravity[c];
  if (damping < 1.0f)
    for (int c = 0; c < 3; ++c) v[c] = v[c] * damping;

  if (has_mesh) {
    const float w = mesh_w[cell];
    if (w > kEps) {
      const float* acc = mesh_acc + 6 * cell;
      float mvel[3], nrm[3];
      for (int c = 0; c < 3; ++c) mvel[c] = acc[c] / w;
      const float nl = fmaxf(
          sqrtf(acc[3] * acc[3] + acc[4] * acc[4] + acc[5] * acc[5]), 1e-12f);
      for (int c = 0; c < 3; ++c) nrm[c] = acc[3 + c] / nl;
      float rel[3];
      for (int c = 0; c < 3; ++c) rel[c] = v[c] - mvel[c];
      const float nc = rel[0] * nrm[0] + rel[1] * nrm[1] + rel[2] * nrm[2];
      const float ncm = fminf(nc, 0.0f);
      float pr[3];
      for (int c = 0; c < 3; ++c) pr[c] = rel[c] - ncm * nrm[c];
      const float vpl =
          sqrtf(pr[0] * pr[0] + pr[1] * pr[1] + pr[2] * pr[2] + 1e-40f);
      const float fric = fmaxf(0.0f, vpl + nc * *mesh_friction);
      const bool f_act = (nc < 0.0f) && (vpl > 1e-20f);
      const float rat = f_act ? fric / vpl : 1.0f;
      for (int c = 0; c < 3; ++c) v[c] = rat * pr[c] + mvel[c];
    }
  }

  if (has_mover) {
    const float w = mover_w[cell];
    if (w > kEps)
      for (int c = 0; c < 3; ++c) v[c] = mover_v[3 * cell + c] / w;
  }

  for (int si = 0; si < n_surf; ++si) {
    const float* sp = surf + 9 * si;
    const int stype = (surf_types >> (2 * si)) & 3;
    const float dotp = (gi[0] * cell_size - sp[0]) * sp[3]
                       + (gi[1] * cell_size - sp[1]) * sp[4]
                       + (gi[2] * cell_size - sp[2]) * sp[5];
    const bool inside = (time >= sp[7]) && (time < sp[8]) && (dotp < 0.0f);
    if (!inside) continue;
    if (stype == 0) {
      v[0] = v[1] = v[2] = 0.0f;
      continue;
    }
    const float nc = v[0] * sp[3] + v[1] * sp[4] + v[2] * sp[5];
    const float cut = stype == 1 ? nc : fminf(nc, 0.0f);
    float v2[3];
    for (int c = 0; c < 3; ++c) v2[c] = v[c] - cut * sp[3 + c];
    const float vlen =
        sqrtf(v2[0] * v2[0] + v2[1] * v2[1] + v2[2] * v2[2] + 1e-40f);
    const float fr = fmaxf(0.0f, vlen + nc * sp[6]);
    const bool fa = (nc < 0.0f) && (vlen > 1e-20f);
    const float rat = fa ? fr / vlen : 1.0f;
    for (int c = 0; c < 3; ++c) v[c] = rat * v2[c];
  }

  if (has_bbox) {
    for (int a = 0; a < 3; ++a) {
      const bool low = (gi[a] < bbox_pad) && (v[a] < 0.0f);
      const bool high = (gi[a] >= G - bbox_pad) && (v[a] > 0.0f);
      if (low || high) v[a] = 0.0f;
    }
  }
  for (int c = 0; c < 3; ++c) out[3 * cell + c] = v[c];
}

}  // namespace

extern "C" int launch_grid_pipeline(
    const float* gv, const float* gm, const float* mesh_acc,
    const float* mesh_w, const float* mover_v, const float* mover_w,
    const float* gravity, const float* damping, const float* mesh_friction,
    const float* surf, float time, float dt, const float* time_p, int cell0,
    int n_cells, int G, float cell_size, int has_mesh, int has_mover,
    int n_surf, int surf_types, int has_bbox, int bbox_pad, float* out,
    void* stream) {
  const int threads = 256;
  const int blocks = (n_cells + threads - 1) / threads;
  grid_pipeline_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      gv, gm, mesh_acc, mesh_w, mover_v, mover_w, gravity, damping,
      mesh_friction, surf, time, dt, time_p, cell0, n_cells,
      G, cell_size, has_mesh, has_mover, n_surf, surf_types, has_bbox,
      bbox_pad, out);
  return static_cast<int>(cudaGetLastError());
}
