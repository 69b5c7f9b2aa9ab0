"""Pinned NumPy oracles re-deriving the reference C++ math.

These are straight-line float64 NumPy implementations of the reference
algorithms (same constants, same border conventions) used as golden
references for the JAX implementations (SURVEY.md §4: golden-EPE vs a
pinned CPU reimplementation). They are deliberately slow and simple.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import convolve as nd_convolve


# ---------------------------------------------------------------------------
# Horn-Schunck demo oracle (hornSchunck.cpp:19-75)


def sobel_reflect101(img: np.ndarray, axis: str) -> np.ndarray:
    kx = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    k = kx if axis == "x" else kx.T
    # scipy convolve flips the kernel; pass flipped to get correlation.
    return nd_convolve(img, k[::-1, ::-1], mode="mirror")


def box_zero(img: np.ndarray, size: int) -> np.ndarray:
    k = np.ones((size, size)) / size**2
    return nd_convolve(img, k, mode="constant", cval=0.0)


def horn_schunck_oracle(prev, nxt, window_size=5, iters=100, alpha=1.0):
    prev = prev.astype(np.float64)
    nxt = nxt.astype(np.float64)
    gx = sobel_reflect101(prev, "x")
    gy = sobel_reflect101(prev, "y")
    gt = nxt - prev
    u = np.zeros_like(gt)
    v = np.zeros_like(gt)
    denom = alpha**2 + gx**2 + gy**2
    for _ in range(iters):
        ub = box_zero(u, window_size)
        vb = box_zero(v, window_size)
        upd = (gx * ub + gy * vb + gt) / denom
        u = ub - gx * upd
        v = vb - gy * upd
    return u, v


# ---------------------------------------------------------------------------
# Pyramid oracle (MultiResolution.cpp)


def mirror_get(img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    h, w = img.shape

    def m(i, n):
        i = np.mod(i, 2 * n)
        return np.where(i >= n, 2 * n - 1 - i, i)

    return img[m(y, h), m(x, w)]


def pyramider_oracle(img: np.ndarray, max_level: int) -> list[np.ndarray]:
    a = 0.4
    w = np.array([a / 2, 0.5, a, 0.5, a / 2])
    w = w / w.sum()
    levels = [img.astype(np.float64)]
    for lev in range(1, max_level + 1):
        wl = int(np.ceil(img.shape[1] * 0.5**lev))
        hl = int(np.ceil(img.shape[0] * 0.5**lev))
        prev = levels[-1]
        out = np.zeros((hl, wl))
        xs, ys = np.meshgrid(np.arange(wl), np.arange(hl))
        for m_ in range(5):
            for n_ in range(5):
                out += w[m_] * w[n_] * mirror_get(
                    prev, 2 * xs + n_ - 2, 2 * ys + m_ - 2)
        levels.append(out)
    return levels


def grad_pyramid_oracle(levels, levels_tp1=None):
    grads = []
    for li, lv in enumerate(levels):
        h, w = lv.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        x = np.clip(xs, 0, w - 2)
        y = np.clip(ys, 0, h - 2)
        gx = (lv[y, x + 1] - lv[y, x] + lv[y + 1, x + 1] - lv[y + 1, x]) / 2.0
        gy = (lv[y + 1, x] - lv[y, x] + lv[y + 1, x + 1] - lv[y, x + 1]) / 2.0
        if levels_tp1 is not None:
            l2 = levels_tp1[li]
            gx = gx + (l2[y, x + 1] - l2[y, x] + l2[y + 1, x + 1] - l2[y + 1, x]) / 2.0
            gy = gy + (l2[y + 1, x] - l2[y, x] + l2[y + 1, x + 1] - l2[y, x + 1]) / 2.0
        grads.append((gx, gy))
    return grads


def dt_pyramid_oracle(levels_t, levels_tp1):
    dts = []
    for lt, ltp in zip(levels_t, levels_tp1):
        h, w = lt.shape
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        x = np.clip(xs, 0, w - 2)
        y = np.clip(ys, 0, h - 2)
        dt = (
            ltp[y, x] - lt[y, x]
            + ltp[y, x + 1] - lt[y, x + 1]
            + ltp[y + 1, x] - lt[y + 1, x]
            + ltp[y + 1, x + 1] - lt[y + 1, x + 1]
        ) / 4.0
        dts.append(dt)
    return dts


# ---------------------------------------------------------------------------
# M-estimators (MEstimator.cpp)


def gm_rho(x, sigma):
    return x**2 / (sigma + x**2)


def gm_psi(x, sigma):
    return 2.0 * x * sigma / (sigma + x**2) ** 2


# ---------------------------------------------------------------------------
# Black-Anandan IRLS oracle (OpticalFlow.cpp:213-378), small images only.


def zeropad_get(img, x, y):
    h, w = img.shape
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xs = np.clip(x, 0, w - 1)
    ys = np.clip(y, 0, h - 1)
    return np.where(ok, img[ys, xs], 0.0)


def irls_sweep_oracle(u, v, gx, gy, it, lambda_d, lambda_s, sigma_d, sigma_s,
                      sup_x, sup_y):
    """One Jacobi IRLS sweep (Error_u at every site, then update)."""
    h, w = u.shape
    center = gm_psi(gx * u + gy * v + it, sigma_d)
    nx = np.zeros_like(u)
    ny = np.zeros_like(u)
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        xs = np.arange(w) + dx
        ys = np.arange(h) + dy
        valid = ((xs >= 0) & (xs < w))[None, :] & ((ys >= 0) & (ys < h))[:, None]
        un = u[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]]
        vn = v[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]]
        nx += np.where(valid, gm_psi(u - un, sigma_s), 0.0)
        ny += np.where(valid, gm_psi(v - vn, sigma_s), 0.0)
    dEx = lambda_d * gx * center + lambda_s * nx
    dEy = lambda_d * gy * center + lambda_s * ny
    return u - dEx / sup_x, v - dEy / sup_y


def irls_energy_oracle(u, v, gx, gy, it, lambda_d, lambda_s, sigma_d, sigma_s):
    h, w = u.shape
    center = gm_rho(gx * u + gy * v + it, sigma_d)
    E = lambda_d * np.sum(center)
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        xs = np.arange(w) + dx
        ys = np.arange(h) + dy
        valid = ((xs >= 0) & (xs < w))[None, :] & ((ys >= 0) & (ys < h))[:, None]
        un = u[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]]
        vn = v[np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]]
        E += lambda_s * np.sum(np.where(valid, gm_rho(u - un, sigma_s), 0.0))
        E += lambda_s * np.sum(np.where(valid, gm_rho(v - vn, sigma_s), 0.0))
    return E


# ---------------------------------------------------------------------------
# Full Black-Anandan pyramid oracle (OpticalFlow.cpp:22-166), small images.


def optical_flow_pyramid_oracle(it_img, itp1_img, max_int, level,
                                err_min=1e-6, iter_scale=1.0, fuse=None):
    """Coarse-to-fine Black-Anandan (OpticalFlow.cpp:131-270). ``fuse``
    gives the semantics of the fused-block path
    (tpuflow.solvers.black_anandan_fast): sweeps run in whole blocks of
    ``fuse``, and the stop test runs after every 64 sweeps at level 0
    and after every block above."""
    import math

    lam_d, lam_s = 5.0, 1.0
    sd_init, sd_l0 = 0.8 / math.sqrt(2), 0.2 / math.sqrt(2)
    ss_init, ss_l0 = 0.3 / math.sqrt(2), 0.03 / math.sqrt(2)
    it_n = it_img.astype(np.float64) / max_int
    itp1_n = itp1_img.astype(np.float64) / max_int
    lt = pyramider_oracle(it_n, level)
    ltp = pyramider_oracle(itp1_n, level)
    max_level = len(lt) - 1
    dts = dt_pyramid_oracle(lt, ltp)
    grads = grad_pyramid_oracle(lt)
    h0, w0 = it_img.shape
    u = v = None
    for lev in range(max_level, -1, -1):
        if max_level > 0:
            sd = sd_init + (sd_l0 - sd_init) / max_level * (max_level - lev)
            ss = ss_init + (ss_l0 - ss_init) / max_level * (max_level - lev)
        else:
            sd, ss = sd_l0, ss_l0
        gx, gy = grads[lev]
        h, w = gx.shape
        if lev < max_level:
            # LevelDown: dt under floor(2 u_coarse) zero-pad warp.
            xs, ys = np.meshgrid(np.arange(w), np.arange(h))
            uo = u[np.minimum(ys // 2, u.shape[0] - 1),
                   np.minimum(xs // 2, u.shape[1] - 1)]
            vo = v[np.minimum(ys // 2, v.shape[0] - 1),
                   np.minimum(xs // 2, v.shape[1] - 1)]
            ox = np.floor(2.0 * uo).astype(int)
            oy = np.floor(2.0 * vo).astype(int)
            acc = np.zeros((h, w))
            for dy in (0, 1):
                for dx in (0, 1):
                    acc += zeropad_get(ltp[lev], xs + dx + ox, ys + dy + oy)
                    acc -= zeropad_get(lt[lev], xs + dx, ys + dy)
            it_l = acc / 4.0
        else:
            it_l = dts[lev]
        sup_x = lam_d * np.max(gx**2) / sd**2 + 4 * lam_s / ss**2
        sup_y = lam_d * np.max(gy**2) / sd**2 + 4 * lam_s / ss**2
        ul = np.zeros((h, w))
        vl = np.zeros((h, w))
        iters = int((lev + 1) * 10 * max(w0, h0) * iter_scale)
        E = 0.0
        inc = 0
        if fuse:
            every = max((64 if lev == 0 else fuse) // fuse, 1) * fuse
            iters = -(-iters // fuse) * fuse
        for n in range(iters):
            ul, vl = irls_sweep_oracle(ul, vl, gx, gy, it_l, lam_d, lam_s,
                                       sd, ss, sup_x, sup_y)
            if fuse:
                if (n + 1) % every:
                    continue
                E_prev = E
                E = irls_energy_oracle(ul, vl, gx, gy, it_l, lam_d, lam_s,
                                       sd, ss)
                if lev > 0:
                    inc = inc + 1 if E > E_prev else 0
            elif lev == 0:
                if (n & 0x3F) == 0:
                    E = irls_energy_oracle(ul, vl, gx, gy, it_l, lam_d,
                                           lam_s, sd, ss)
            else:
                E_prev = E
                E = irls_energy_oracle(ul, vl, gx, gy, it_l, lam_d, lam_s,
                                       sd, ss)
                inc = inc + 1 if E > E_prev else 0
            if E < err_min or inc > 3:
                break
        if lev < max_level:
            xs, ys = np.meshgrid(np.arange(w), np.arange(h))
            ul = ul + 2.0 * u[np.minimum(ys // 2, u.shape[0] - 1),
                              np.minimum(xs // 2, u.shape[1] - 1)]
            vl = vl + 2.0 * v[np.minimum(ys // 2, v.shape[0] - 1),
                              np.minimum(xs // 2, v.shape[1] - 1)]
        u, v = ul, vl
    return u, v


# ---------------------------------------------------------------------------
# Region-gated IRLS oracle (OpticalFlow_BlockMatching.cpp:412-590):
# Jacobi sweeps with the region-gated, direction-coherence-weighted
# neighbor term (Error_u_Block :465-514) and the matching total energy
# (Error_MultipleMotion_Block :540-590).


def _gated_neighbor_fields(u, v, labels, sigma_s):
    """Per-offset (psi_x, psi_y, rho) neighbor sums with the in-bounds &
    same-region gate and coeff = 0.5*(1+cos angle); cos is taken as 1
    where either vector is zero (the zero-field limit of the reference's
    0/0)."""
    h, w = u.shape
    norm = np.sqrt(u * u + v * v)
    nx = np.zeros_like(u)
    ny = np.zeros_like(u)
    erho = np.zeros_like(u)
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        xs = np.arange(w) + dx
        ys = np.arange(h) + dy
        valid = (((xs >= 0) & (xs < w))[None, :]
                 & ((ys >= 0) & (ys < h))[:, None])
        yi = np.clip(ys, 0, h - 1)[:, None]
        xi = np.clip(xs, 0, w - 1)[None, :]
        un, vn = u[yi, xi], v[yi, xi]
        gate = valid & (labels[yi, xi] == labels)
        prod = norm * norm[yi, xi]
        cosang = np.where(prod > 0,
                          (u * un + v * vn) / np.maximum(prod, 1e-30), 1.0)
        m = gate * 0.5 * (1.0 + cosang)
        nx += m * gm_psi(u - un, sigma_s)
        ny += m * gm_psi(v - vn, sigma_s)
        erho += m * (gm_rho(u - un, sigma_s) + gm_rho(v - vn, sigma_s))
    return nx, ny, erho


def gated_irls_sweep_oracle(u, v, gx, gy, it, labels, lambda_d, lambda_s,
                            sigma_d, sigma_s, sup_x, sup_y):
    """One region-gated Jacobi IRLS sweep."""
    psi_d = gm_psi(gx * u + gy * v + it, sigma_d)
    nx, ny, _ = _gated_neighbor_fields(u, v, labels, sigma_s)
    return (u - (lambda_d * gx * psi_d + lambda_s * nx) / sup_x,
            v - (lambda_d * gy * psi_d + lambda_s * ny) / sup_y)


def gated_irls_energy_oracle(u, v, gx, gy, it, labels, lambda_d, lambda_s,
                             sigma_d, sigma_s):
    _, _, erho = _gated_neighbor_fields(u, v, labels, sigma_s)
    center = gm_rho(gx * u + gy * v + it, sigma_d)
    return np.sum(lambda_d * center + lambda_s * erho)
