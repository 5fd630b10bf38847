// Z-buffer triangle rasterizer of the port's reconstruction metrics: the
// depth image of a triangle mesh from one camera pose, on the host. A copy
// of raster_depth in loopy_slam_tpu/native/matcher.cpp (same arithmetic,
// so the two give the same images bit for bit), compiled on its own by
// loopy_slam_torch/csrc/build.py (g++, plain C ABI, loaded with ctypes).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Z-buffer triangle rasterization to a depth image.
// verts: (V,3) float32 world coords; faces: (F,3) int32; w2c: 4x4
// row-major world->camera. Camera convention matches the repo's datasets
// (ops/raster.py, tools/cull_mesh.py): the camera looks down -z, so the
// optical-axis depth is -z_cam, u = fx*x/(-z) + cx, v = -fy*y/(-z) + cy.
// out: (H*W) float32, 0 where nothing is hit. Depth is perspective-correct
// (1/z interpolated with screen-space barycentrics). Triangles with any
// vertex behind the near plane are skipped (no clipping — negligible for
// the room-scale interior views this serves).
// ---------------------------------------------------------------------
int raster_depth(const float* verts, int V, const int32_t* faces, int F,
                 const double* w2c, int H, int W,
                 double fx, double fy, double cx, double cy,
                 float* out) {
    const double kNear = 1e-4;
    std::vector<double> u(V), v(V), iz(V);   // screen coords + inverse depth
    std::vector<uint8_t> front(V);
    for (int i = 0; i < V; ++i) {
        double X = verts[3 * i], Y = verts[3 * i + 1], Zw = verts[3 * i + 2];
        double xc = w2c[0] * X + w2c[1] * Y + w2c[2] * Zw + w2c[3];
        double yc = w2c[4] * X + w2c[5] * Y + w2c[6] * Zw + w2c[7];
        double zc = w2c[8] * X + w2c[9] * Y + w2c[10] * Zw + w2c[11];
        double z = -zc;  // optical-axis depth
        front[i] = z > kNear;
        if (!front[i]) continue;
        u[i] = fx * xc / z + cx;
        v[i] = -fy * yc / z + cy;
        iz[i] = 1.0 / z;
    }
    for (long p = 0; p < (long)H * W; ++p) out[p] = 0.0f;
    std::vector<double> zbuf((long)H * W, 0.0);  // stores max 1/z
    for (int f = 0; f < F; ++f) {
        int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        if (!front[a] || !front[b] || !front[c]) continue;
        double ux0 = u[a], uy0 = v[a], ux1 = u[b], uy1 = v[b];
        double ux2 = u[c], uy2 = v[c];
        double area = (ux1 - ux0) * (uy2 - uy0) - (ux2 - ux0) * (uy1 - uy0);
        if (std::fabs(area) < 1e-12) continue;
        int x0 = (int)std::floor(std::fmin(ux0, std::fmin(ux1, ux2)));
        int x1 = (int)std::ceil(std::fmax(ux0, std::fmax(ux1, ux2)));
        int y0 = (int)std::floor(std::fmin(uy0, std::fmin(uy1, uy2)));
        int y1 = (int)std::ceil(std::fmax(uy0, std::fmax(uy1, uy2)));
        if (x0 < 0) x0 = 0; if (y0 < 0) y0 = 0;
        if (x1 >= W) x1 = W - 1; if (y1 >= H) y1 = H - 1;
        if (x0 > x1 || y0 > y1) continue;
        double inv_area = 1.0 / area;
        for (int py = y0; py <= y1; ++py) {
            for (int px_ = x0; px_ <= x1; ++px_) {
                double sx = px_ + 0.0, sy = py + 0.0;
                double w0 = ((ux1 - sx) * (uy2 - sy)
                             - (ux2 - sx) * (uy1 - sy)) * inv_area;
                double w1 = ((ux2 - sx) * (uy0 - sy)
                             - (ux0 - sx) * (uy2 - sy)) * inv_area;
                double w2 = 1.0 - w0 - w1;
                if (w0 < 0 || w1 < 0 || w2 < 0) continue;
                double invz = w0 * iz[a] + w1 * iz[b] + w2 * iz[c];
                long idx = (long)py * W + px_;
                if (invz > zbuf[idx]) {
                    zbuf[idx] = invz;
                    out[idx] = (float)(1.0 / invz);
                }
            }
        }
    }
    return 0;
}

}  // extern "C"
