"""Fused-sweep stencil bodies for the Jacobi relaxations (plain jnp).

The reference's hot loops (HS box-Jacobi, hornSchunck.cpp:43-75; the
Black-Anandan IRLS sweep, OpticalFlow.cpp:213-270; the region-gated BM
refine, OpticalFlow_BlockMatching.cpp:465-514) are Jacobi sweeps over
the whole frame. The bodies here run ``fuse`` sweeps on a halo'd tile
with statically shrinking valid regions: a tile padded by ``fuse * r``
(r = stencil radius) yields its exact core after ``fuse`` sweeps, so
one halo exchange (``tpuflow.dist``) or one zero-padded whole frame
(:func:`irls_sweep_fused`) serves ``fuse`` iterations.

Border semantics: masks from *global* image coordinates re-zero u, v
outside the frame (HS, BORDER_CONSTANT) or drop neighbor terms across
the frame edge (IRLS, the reference's ``get_zeropad``-excluded border,
OpticalFlow.cpp:281-303), so any tiling is the same Jacobi iteration as
the single-array sweep.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def box_sum_valid(a: jnp.ndarray, taps: int) -> jnp.ndarray:
    """Separable box *sum* over taps x taps; output shrinks by taps-1."""
    h, w = a.shape
    rows = a[0 : h - taps + 1, :]
    for d in range(1, taps):
        rows = rows + a[d : h - taps + 1 + d, :]
    out = rows[:, 0 : w - taps + 1]
    for d in range(1, taps):
        out = out + rows[:, d : w - taps + 1 + d]
    return out


def inside_mask(row0, col0, ch: int, cw: int, img_h: int, img_w: int,
                dtype):
    """Float inside-image mask for a (ch, cw) tile whose local (0, 0)
    sits at global (row0, col0) (traced scalars allowed)."""
    ly = jax.lax.broadcasted_iota(jnp.int32, (ch, cw), 0)
    lx = jax.lax.broadcasted_iota(jnp.int32, (ch, cw), 1)
    gy_img = row0 + ly
    gx_img = col0 + lx
    return ((gy_img >= 0) & (gy_img < img_h)
            & (gx_img >= 0) & (gx_img < img_w)).astype(dtype)


def hs_sweeps(u, v, gxa, gya, gta, inva, mask_full, window: int,
              fuse: int):
    """``fuse`` HS Jacobi sweeps on a halo'd tile with statically
    shrinking valid regions; ``mask_full`` re-zeroes u, v outside the
    frame after every sweep (BORDER_CONSTANT). Inputs are (hh, hw);
    returns the (hh - 2*fuse*r, hw - 2*fuse*r) core."""
    hh, hw = u.shape
    r = window // 2
    inv_area = jnp.asarray(1.0 / (window * window), u.dtype)
    for t in range(fuse):
        o = r * (t + 1)
        sh = hh - 2 * r * (t + 1)
        sw = hw - 2 * r * (t + 1)
        ub = box_sum_valid(u, window) * inv_area
        vb = box_sum_valid(v, window) * inv_area
        gxc = gxa[o : o + sh, o : o + sw]
        gyc = gya[o : o + sh, o : o + sw]
        gtc = gta[o : o + sh, o : o + sw]
        invc = inva[o : o + sh, o : o + sw]
        mc = mask_full[o : o + sh, o : o + sw]
        upd = (gxc * ub + gyc * vb + gtc) * invc
        u = (ub - gxc * upd) * mc
        v = (vb - gyc * upd) * mc
    return u, v


def psi_gm(x, sigma):
    """Geman-McClure influence: 2 x sigma / (sigma + x^2)^2 — same sigma
    convention as tpuflow.solvers.mestimators (MEstimator.cpp:12-16)."""
    d = sigma + x * x
    return 2.0 * x * sigma / (d * d)


def nb_masks(row0, col0, ch: int, cw: int, img_h: int, img_w: int, dt):
    """Per-direction neighbor-validity masks (float) from global coords
    for a (ch, cw) tile whose local (0, 0) sits at global (row0, col0)."""
    ly = jax.lax.broadcasted_iota(jnp.int32, (ch, cw), 0)
    lx = jax.lax.broadcasted_iota(jnp.int32, (ch, cw), 1)
    gy_img = row0 + ly
    gx_img = col0 + lx
    masks = {}
    for dx, dy in _NEIGHBORS:
        nb_ok = ((gy_img + dy >= 0) & (gy_img + dy < img_h)
                 & (gx_img + dx >= 0) & (gx_img + dx < img_w))
        masks[(dx, dy)] = nb_ok.astype(dt)
    return masks


def irls_sweeps(u, v, gxa, gya, ita, masks, sup_x, sup_y, fuse: int,
                lambda_d: float, lambda_s: float,
                sigma_d: float, sigma_s: float):
    """``fuse`` IRLS Jacobi sweeps on a halo'd tile with statically
    shrinking valid regions (stencil radius 1). Inputs (hh, hw); returns
    the (hh - 2*fuse, hw - 2*fuse) core."""
    hh, hw = u.shape
    for t in range(fuse):
        s_h = hh - 2 * t
        s_w = hw - 2 * t
        ctr = (slice(1, s_h - 1), slice(1, s_w - 1))
        uc = u[ctr]
        vc = v[ctr]
        o = t + 1
        gxc = gxa[o : o + s_h - 2, o : o + s_w - 2]
        gyc = gya[o : o + s_h - 2, o : o + s_w - 2]
        itc = ita[o : o + s_h - 2, o : o + s_w - 2]

        psi_d = psi_gm(gxc * uc + gyc * vc + itc, sigma_d)
        nx = jnp.zeros_like(uc)
        ny = jnp.zeros_like(vc)
        for dx, dy in _NEIGHBORS:
            un = u[1 + dy : s_h - 1 + dy, 1 + dx : s_w - 1 + dx]
            vn = v[1 + dy : s_h - 1 + dy, 1 + dx : s_w - 1 + dx]
            m = masks[(dx, dy)][o : o + s_h - 2, o : o + s_w - 2]
            nx = nx + m * psi_gm(uc - un, sigma_s)
            ny = ny + m * psi_gm(vc - vn, sigma_s)
        u = uc - (lambda_d * gxc * psi_d + lambda_s * nx) / sup_x
        v = vc - (lambda_d * gyc * psi_d + lambda_s * ny) / sup_y
    return u, v


def irls_sweeps_gated(u, v, gxa, gya, ita, laba, masks, sup_x, sup_y,
                      fuse: int, lambda_d: float, lambda_s: float,
                      sigma_d: float, sigma_s: float):
    """``fuse`` REGION-GATED IRLS sweeps (Error_u_Block,
    OpticalFlow_BlockMatching.cpp:465-514): the neighbor term is gated by
    label equality and weighted by the direction-coherence factor
    0.5 * (1 + cos(u, u_nbr)) — bitwise the math of
    tpuflow.solvers.bm_flow._neighbor_terms, on a halo'd tile with
    statically shrinking valid regions. ``laba`` carries the region
    labels as floats (exact for the int region ids)."""
    hh, hw = u.shape
    # Sweep-invariant label gates at full halo resolution, sliced per
    # sweep.
    gate_full = {}
    for dx, dy in _NEIGHBORS:
        ln_f = laba[1 + dy : hh - 1 + dy, 1 + dx : hw - 1 + dx]
        lab_c = laba[1 : hh - 1, 1 : hw - 1]
        inb_f = masks[(dx, dy)][1 : hh - 1, 1 : hw - 1]
        gate_full[(dx, dy)] = inb_f * (ln_f == lab_c).astype(u.dtype)
    for t in range(fuse):
        s_h = hh - 2 * t
        s_w = hw - 2 * t
        ctr = (slice(1, s_h - 1), slice(1, s_w - 1))
        uc = u[ctr]
        vc = v[ctr]
        o = t + 1
        gxc = gxa[o : o + s_h - 2, o : o + s_w - 2]
        gyc = gya[o : o + s_h - 2, o : o + s_w - 2]
        itc = ita[o : o + s_h - 2, o : o + s_w - 2]

        psi_d = psi_gm(gxc * uc + gyc * vc + itc, sigma_d)
        # Neighbor norms are SLICES of one norm field over the current
        # halo'd u/v (bitwise: sqrt commutes with the shift).
        norm_f = jnp.sqrt(u * u + v * v)
        norm_c = norm_f[ctr]
        nx = jnp.zeros_like(uc)
        ny = jnp.zeros_like(vc)
        for dx, dy in _NEIGHBORS:
            un = u[1 + dy : s_h - 1 + dy, 1 + dx : s_w - 1 + dx]
            vn = v[1 + dy : s_h - 1 + dy, 1 + dx : s_w - 1 + dx]
            gate = gate_full[(dx, dy)][t : t + s_h - 2, t : t + s_w - 2]
            nn = norm_f[1 + dy : s_h - 1 + dy, 1 + dx : s_w - 1 + dx]
            prod = norm_c * nn
            cosang = jnp.where(prod > 0,
                               (uc * un + vc * vn)
                               / jnp.maximum(prod, 1e-30), 1.0)
            m = gate * (0.5 * (1.0 + cosang))
            nx = nx + m * psi_gm(uc - un, sigma_s)
            ny = ny + m * psi_gm(vc - vn, sigma_s)
        u = uc - (lambda_d * gxc * psi_d + lambda_s * nx) / sup_x
        v = vc - (lambda_d * gyc * psi_d + lambda_s * ny) / sup_y
    return u, v


@partial(jax.jit, static_argnames=("n_iters", "lambda_d", "lambda_s",
                                   "sigma_d", "sigma_s", "fuse"))
def irls_sweep_fused(u, v, gx, gy, it, sup_x, sup_y, n_iters: int,
                     lambda_d: float = 5.0, lambda_s: float = 1.0,
                     sigma_d: float = 0.1, sigma_s: float = 0.1,
                     fuse: int = 16):
    """``n_iters`` whole-frame IRLS sweeps in blocks of ``fuse``
    (:func:`irls_sweeps` on the frame zero-padded by the block's halo);
    returns (u, v). Bitwise ``n_iters`` applications of
    ``tpuflow.solvers.black_anandan.irls_grad`` + step, for any
    ``fuse``."""
    h, w = u.shape
    dt = u.dtype

    def run_block(u, v, k):
        pad = lambda a: jnp.pad(a, k)  # noqa: E731
        masks = nb_masks(-k, -k, h + 2 * k, w + 2 * k, h, w, dt)
        return irls_sweeps(pad(u), pad(v), pad(gx), pad(gy), pad(it), masks,
                           sup_x, sup_y, k, lambda_d, lambda_s, sigma_d,
                           sigma_s)

    n_full, rem = divmod(n_iters, fuse)
    if n_full:
        u, v = jax.lax.fori_loop(
            0, n_full, lambda _, uv: run_block(*uv, fuse), (u, v))
    if rem:
        u, v = run_block(u, v, rem)
    return u, v
