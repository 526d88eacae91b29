// The divergence right-hand side b = div(fluxes) of the sigma-coordinate
// volume fluxes, in one pass over the fields.
//
// Replaces no Pallas kernel: the JAX package leaves
// mgroms_tpu/ops/rhs.py:compute_rhs to XLA, which fuses its elementwise
// expression into a few passes.  The port's plain version
// (ops/rhs.compute_rhs, reference mg_compute_rhs.f90:14-379) runs some 150
// eager elementwise passes over full fields and ~60 full-volume
// temporaries.  This kernel computes, term for term and in the same
// operation order, what that function computes: the u-, v- and w-fluxes
// with their slope terms, the bottom cell's metric terms (plane 0), the
// vertical weights wlo/whi/k0, the masks, the face masks (the walls, or a
// tile's, parallel/exchange.shard_face_masks; none with bmask) and the
// divergence ((((uf_e - uf_w) + vf_n) - vf_s) + wf(k+1)) - wf(k).
//
// What bounds it: memory.  It needs u, v, w, zw, dzw, cw, zx and zy once,
// five (ny+2) x (nx+2) planes, and b written once: at CUC 1024^2 x 64 in
// float32 2.46 GB, 0.735 ms at 3.35 TB/s, against ~0.1 flop a byte.  The
// design moves each of those bytes once:
//
// - One thread per (j, i) column walks z from the bottom to the surface;
//   a block owns a kTileX x kTileY tile of columns, i fastest, so a warp
//   reads 32 adjacent values of every field.
// - What the next plane reuses stays in registers: the w-level fields
//   (zw, dzw, w) of the lower face at the column and its four neighbours,
//   the lower face's w-flux, uterm/vterm of plane k for wf_int's two-plane
//   averages.  The bottom cell's cross terms, which only plane 0 needs,
//   are computed once before the walk; k0 * them is applied at every
//   plane, as the plain version does.
// - The loads run a plane ahead of the arithmetic: while plane k is
//   computed, the w-level k + 2 and the u, v, zx and zy values of plane
//   k + 2 are in flight, so a thread keeps two planes of loads
//   outstanding (the cap of 128 registers a thread in float32 leaves 4
//   blocks of 128 threads an SM).
// - The one-column halos in x and y are the neighbouring threads' own
//   values, served by L1, at a tile's edge by L2 (the neighbouring block
//   walks the same planes at about the same time), so device memory sees
//   each value about once.  No flux field is written: each face's flux is
//   computed by both columns beside it (flops are cheap here, bytes not).
//   The tile and the register cap are the fastest of those measured on
//   the H100; without the plane-ahead loads the kernel took 1.2x as long
//   (PERF.md).
//
// Rounding: built with -fmad=false and IEEE division (0 ulp from the plain
// version).
//
// Plain C interface (loaded with ctypes): the entry launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>

// Pointers of one launch (ops/kernels/rhs_fused._RhsArgs): velocities
// u (nz, ny+2, nx+1), v (nz, ny+1, nx+2), w (nz+1, ny+2, nx+2); the
// metrics of assembly.FineMetrics on the (ny+2, nx+2) halo-1 grid, zw
// through its own plane and row strides (a view of the halo-2 field); the
// face masks (ny, nx+1) and (ny+1, nx), null with bmask; b (nz, ny, nx).
struct RhsArgs {
    const void* u;
    const void* v;
    const void* w;
    const void* dx;
    const void* dy;
    const void* zw;
    const void* dzw;
    const void* zx;
    const void* zy;
    const void* cw;
    const void* umask;
    const void* vmask;
    const void* rmask;
    const void* uface;
    const void* vface;
    void* out;
    long long zw_plane;
    long long zw_row;
};

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 2;
// blocks an SM, which caps the registers a thread: 4 (128 registers) in
// float32, where no value spills; float64 takes twice the registers
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 4 : 2; }

// The five columns a thread reads at a level: its own and its neighbours.
enum { C = 0, W = 1, E = 2, S = 3, N = 4 };

// zw, dzw and w of one w-level at the five columns.
template <typename T>
struct WLevel {
    T zw[5], dzw[5], w[5];
};

template <typename T>
struct Fields {
    const T* __restrict__ u;
    const T* __restrict__ v;
    const T* __restrict__ w;
    const T* __restrict__ dx;
    const T* __restrict__ dy;
    const T* __restrict__ zw;
    const T* __restrict__ dzw;
    const T* __restrict__ zx;
    const T* __restrict__ zy;
    const T* __restrict__ cw;
    const T* __restrict__ umask;
    const T* __restrict__ vmask;
    const T* __restrict__ rmask;
    long long I, P;          // metric row and plane: nx+2, (ny+2)(nx+2)
    long long UI, UP;        // u's row and plane: nx+1, (ny+2)(nx+1)
    long long VP;            // v's plane: (ny+1)(nx+2) (its row is I)
    long long ZI, ZP;        // zw's row and plane strides
};

template <typename T>
__device__ __forceinline__ WLevel<T> load_level(const Fields<T>& f, int k,
                                                long long c, long long zc) {
    const long long off[5] = {0, -1, 1, -f.I, f.I};
    const long long zoff[5] = {0, -1, 1, -f.ZI, f.ZI};
    WLevel<T> L;
#pragma unroll
    for (int n = 0; n < 5; ++n) {
        L.zw[n] = f.zw[k * f.ZP + zc + zoff[n]];
        L.dzw[n] = f.dzw[k * f.P + c + off[n]];
        L.w[n] = f.w[k * f.P + c + off[n]];
    }
    return L;
}

// u, v, zx and zy of plane k that the column reads: u on its west and east
// faces, v on its south and north faces, zx along the row, zy along the
// column.
template <typename T>
struct Rho {
    T u_w, u_e, v_s, v_n, zx_w, zx_c, zx_e, zy_s, zy_c, zy_n;
};

template <typename T>
__device__ __forceinline__ Rho<T> load_rho(const Fields<T>& f, int k,
                                           long long c, long long uw,
                                           long long vs) {
    const T* u = f.u + k * f.UP + uw;
    const T* v = f.v + k * f.VP + vs;
    const T* zx = f.zx + k * f.P + c;
    const T* zy = f.zy + k * f.P + c;
    return Rho<T>{u[0], u[1], v[0], v[f.I], zx[-1], zx[0], zx[1],
                  zy[-f.I], zy[0], zy[f.I]};
}

// The k0 term of the u-flux of plane 0 on the face between columns c - 1
// and c of row j (halo indices): slope2_u + cross_u (rhs.py, :113-128).
template <typename T>
__device__ __forceinline__ T u_bottom(const Fields<T>& f, int j, int c) {
    const long long m = j * f.I + c;              // (j, c)
    const T cws = f.cw[m] + f.cw[f.P + m];
    const T cwsw = f.cw[m - 1] + f.cw[f.P + m - 1];
    const T zxc = f.zx[m], zxw = f.zx[m - 1];
    const T zyc = f.zy[m], zyw = f.zy[m - 1];
    const T dxu = T(0.5) * (f.dx[m] + f.dx[m - 1]);
    const T slope2 = (zxc * zxc / cws + zxw * zxw / cwsw) * dxu
                     * f.u[j * f.UI + c - 1];
    // v at (j - 1 + dj, c + di) of plane 0, its dy average and vmask
    const long long vs = (long long)(j - 1) * f.I + c;
    const T vbar = T(0.5) * (T(0.5) * (f.dy[m] + f.dy[m - f.I]) * f.v[vs]
                             * f.vmask[m]
                             + T(0.5) * (f.dy[m + f.I] + f.dy[m]) * f.v[vs + f.I]
                             * f.vmask[m + f.I]);
    const T vbar_im = T(0.5) * (T(0.5) * (f.dy[m - 1] + f.dy[m - f.I - 1])
                                * f.v[vs - 1] * f.vmask[m - 1]
                                + T(0.5) * (f.dy[m + f.I - 1] + f.dy[m - 1])
                                * f.v[vs + f.I - 1] * f.vmask[m + f.I - 1]);
    const T cross = zxc * zyc / cws * vbar + zxw * zyw / cwsw * vbar_im;
    return slope2 + cross;
}

// The k0 term of the v-flux of plane 0 on the face between rows r - 1 and
// r of column i: slope2_v + cross_v (rhs.py, :240-255).
template <typename T>
__device__ __forceinline__ T v_bottom(const Fields<T>& f, int r, int i) {
    const long long m = r * f.I + i;              // (r, i)
    const long long s = m - f.I;                  // (r - 1, i)
    const T cws = f.cw[m] + f.cw[f.P + m];
    const T cwss = f.cw[s] + f.cw[f.P + s];
    const T zyr = f.zy[m], zys = f.zy[s];
    const T zxr = f.zx[m], zxs = f.zx[s];
    const T dyv = T(0.5) * (f.dy[m] + f.dy[s]);
    const T slope2 = (zyr * zyr / cws + zys * zys / cwss) * dyv
                     * f.v[(long long)(r - 1) * f.I + i];
    // u at (r + dj, i - 1 + di) of plane 0, its dx average and umask
    const long long ur = r * f.UI + i - 1, us = ur - f.UI;
    const T ubar = T(0.5) * (T(0.5) * (f.dx[m] + f.dx[m - 1]) * f.u[ur]
                             * f.umask[m]
                             + T(0.5) * (f.dx[m + 1] + f.dx[m]) * f.u[ur + 1]
                             * f.umask[m + 1]);
    const T ubar_jm = T(0.5) * (T(0.5) * (f.dx[s] + f.dx[s - 1]) * f.u[us]
                                * f.umask[s]
                                + T(0.5) * (f.dx[s + 1] + f.dx[s])
                                * f.u[us + 1] * f.umask[s + 1]);
    const T cross = zyr * zxr / cws * ubar + zys * zxs / cwss * ubar_jm;
    return slope2 + cross;
}

// A horizontal flux of plane k on the face between columns q (west or
// south) and p (east or north): arx (ary) * vel - wterm - k0 * bottom,
// times the mask (rhs.py, uf and vf).  lo, hi: the w-levels k and k + 1;
// D: the face's dy (dx) sum; zp, zq: zx (zy) of plane k.
template <typename T>
__device__ __forceinline__ T face_flux(const WLevel<T>& lo,
                                       const WLevel<T>& hi, int p, int q,
                                       T D, T zp, T zq, T rp, T rq, T vel,
                                       T bottom, T mask, T wl, T wh, T k0) {
    const T ar = T(0.25) * (hi.zw[p] - lo.zw[p] + hi.zw[q] - lo.zw[q]) * D;
    const T wterm = T(0.25) * (zp * (wl * lo.dzw[p] * lo.w[p]
                                     + wh * hi.dzw[p] * hi.w[p]) * rp
                               + zq * (wl * lo.dzw[q] * lo.w[q]
                                       + wh * hi.dzw[q] * hi.w[q]) * rq);
    return (ar * vel - wterm - k0 * bottom) * mask;
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kTileY, min_blocks<T>())
rhs_kernel(RhsArgs a, int nz, int ny, int nx) {
    const int ii = blockIdx.x * kTileX + threadIdx.x;
    const int jj = blockIdx.y * kTileY + threadIdx.y;
    if (ii >= nx || jj >= ny) return;

    Fields<T> f;
    f.u = static_cast<const T*>(a.u);
    f.v = static_cast<const T*>(a.v);
    f.w = static_cast<const T*>(a.w);
    f.dx = static_cast<const T*>(a.dx);
    f.dy = static_cast<const T*>(a.dy);
    f.zw = static_cast<const T*>(a.zw);
    f.dzw = static_cast<const T*>(a.dzw);
    f.zx = static_cast<const T*>(a.zx);
    f.zy = static_cast<const T*>(a.zy);
    f.cw = static_cast<const T*>(a.cw);
    f.umask = static_cast<const T*>(a.umask);
    f.vmask = static_cast<const T*>(a.vmask);
    f.rmask = static_cast<const T*>(a.rmask);
    f.I = nx + 2;
    f.P = (long long)(ny + 2) * f.I;
    f.UI = nx + 1;
    f.UP = (long long)(ny + 2) * f.UI;
    f.VP = (long long)(ny + 1) * f.I;
    f.ZI = a.zw_row;
    f.ZP = a.zw_plane;

    const int j = jj + 1, i = ii + 1;            // halo indices
    const long long c = j * f.I + i;
    const long long zc = j * f.ZI + i;
    const long long uw = j * f.UI + i - 1;        // u faces i - 1, i
    const long long vs = (long long)(j - 1) * f.I + i;   // v faces j - 1, j

    // plane-independent factors, each as the plain version forms it
    const T arx_e = f.dy[c + 1] + f.dy[c], arx_w = f.dy[c] + f.dy[c - 1];
    const T ary_n = f.dx[c + f.I] + f.dx[c], ary_s = f.dx[c] + f.dx[c - f.I];
    const T ut_w = f.dx[c] + f.dx[c - 1], ut_e = f.dx[c + 1] + f.dx[c];
    const T vt_s = f.dy[c] + f.dy[c - f.I], vt_n = f.dy[c + f.I] + f.dy[c];
    T rm[5];
    {
        const long long off[5] = {0, -1, 1, -f.I, f.I};
#pragma unroll
        for (int n = 0; n < 5; ++n) rm[n] = f.rmask[c + off[n]];
    }
    const T um_c = f.umask[c], um_e = f.umask[c + 1];
    const T vm_c = f.vmask[c], vm_n = f.vmask[c + f.I];
    const bool faces = a.uface != nullptr;
    T fm_w = T(1), fm_e = T(1), fm_s = T(1), fm_n = T(1);
    if (faces) {
        const T* uface = static_cast<const T*>(a.uface);
        const T* vface = static_cast<const T*>(a.vface);
        fm_w = uface[(long long)jj * (nx + 1) + ii];
        fm_e = uface[(long long)jj * (nx + 1) + ii + 1];
        fm_s = vface[(long long)jj * nx + ii];
        fm_n = vface[(long long)(jj + 1) * nx + ii];
    }
    const T bot_e = u_bottom(f, j, i + 1), bot_w = u_bottom(f, j, i);
    const T bot_n = v_bottom(f, j + 1, i), bot_s = v_bottom(f, j, i);

    // planes 0 and 1 (the loads run a plane ahead of the arithmetic): the
    // lower and upper w-levels, the velocities and slopes, uterm/vterm
    WLevel<T> lo = load_level(f, 0, c, zc);
    WLevel<T> hi = load_level(f, 1, c, zc);
    T cw_hi = f.cw[f.P + c];
    Rho<T> cur = load_rho(f, 0, c, uw, vs);
    Rho<T> nxt{};
    if (nz > 1) nxt = load_rho(f, 1, c, uw, vs);
    T ut = cur.zx_c * (ut_w * cur.u_w * um_c + ut_e * cur.u_e * um_e);
    T vt = cur.zy_c * (vt_s * cur.v_s * vm_c + vt_n * cur.v_n * vm_n);
    T wf_lo = T(0);

    T* out = static_cast<T*>(a.out) + (long long)jj * nx + ii;
    const long long oplane = (long long)ny * nx;
    for (int k = 0; k < nz; ++k) {
        const bool top = k + 1 == nz;
        WLevel<T> pre{};
        Rho<T> pnx{};
        T pcw = T(0);
        if (k + 2 <= nz) {
            pre = load_level(f, k + 2, c, zc);
            pcw = f.cw[(k + 2) * f.P + c];
        }
        if (k + 2 < nz) pnx = load_rho(f, k + 2, c, uw, vs);
        // wlo, whi, k0 (rhs.py): the bottom cell has no lower-face part,
        // the top cell doubles the surface part, k0 selects plane 0
        const T wl = k == 0 ? T(0) : T(1);
        const T wh = top ? T(2) : T(1);
        const T k0 = k == 0 ? T(1) : T(0);

        T uf_e = face_flux(lo, hi, E, C, arx_e, cur.zx_e, cur.zx_c, rm[E],
                           rm[C], cur.u_e, bot_e, um_e, wl, wh, k0);
        T uf_w = face_flux(lo, hi, C, W, arx_w, cur.zx_c, cur.zx_w, rm[C],
                           rm[W], cur.u_w, bot_w, um_c, wl, wh, k0);
        T vf_n = face_flux(lo, hi, N, C, ary_n, cur.zy_n, cur.zy_c, rm[N],
                           rm[C], cur.v_n, bot_n, vm_n, wl, wh, k0);
        T vf_s = face_flux(lo, hi, C, S, ary_s, cur.zy_c, cur.zy_s, rm[C],
                           rm[S], cur.v_s, bot_s, vm_c, wl, wh, k0);
        if (faces) {
            uf_e = uf_e * fm_e;
            uf_w = uf_w * fm_w;
            vf_n = vf_n * fm_n;
            vf_s = vf_s * fm_s;
        }

        T wf_hi;
        const T cwdw = cw_hi * hi.dzw[C] * hi.w[C];
        if (top) {                                  // surface face
            wf_hi = cwdw - T(0.25) * ut - T(0.25) * vt;
        } else {                                    // interior face k + 1
            const T nut = nxt.zx_c * (ut_w * nxt.u_w * um_c
                                      + ut_e * nxt.u_e * um_e);
            const T nvt = nxt.zy_c * (vt_s * nxt.v_s * vm_c
                                      + vt_n * nxt.v_n * vm_n);
            wf_hi = cwdw - T(0.125) * (nut + ut) - T(0.125) * (nvt + vt);
            ut = nut;
            vt = nvt;
        }
        out[k * oplane] = uf_e - uf_w + vf_n - vf_s + wf_hi - wf_lo;

        wf_lo = wf_hi;
        lo = hi;
        hi = pre;
        cw_hi = pcw;
        cur = nxt;
        nxt = pnx;
    }
}

template <typename T>
int launch_rhs(const RhsArgs* a, int nz, int ny, int nx, void* stream) {
    const dim3 block(kTileX, kTileY);
    const dim3 grid((nx + kTileX - 1) / kTileX, (ny + kTileY - 1) / kTileY);
    rhs_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        *a, nz, ny, nx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mg_rhs_fused_f32(const RhsArgs* a, int nz, int ny, int nx,
                     void* stream) {
    return launch_rhs<float>(a, nz, ny, nx, stream);
}

int mg_rhs_fused_f64(const RhsArgs* a, int nz, int ny, int nx,
                     void* stream) {
    return launch_rhs<double>(a, nz, ny, nx, stream);
}

}  // extern "C"
