"""Segmentation-based block-matching flow — the reference's flagship path.

Re-design of ``OpticalFlow/OpticalFlow_BlockMatching.cpp:13-362`` and
``OpticalFlow/Affine_BlockMatching.cpp``:

1. normalize sRGB by MaxInt, convert to CIE Lab
   (OpticalFlow_BlockMatching.cpp:58-81);
2. keep a <=4-frame history of Lab frames + segmentations — here an
   *explicit* :class:`BMFlowState` carried by the caller instead of the
   reference's function-local ``static`` deques (lines 16-22, 84-93;
   SURVEY.md §5.4 makes warm state explicit);
3. mean-shift segmentation of the newest frame
   (:mod:`tpuflow.segmentation`), with segmentation-map /
   color-quantized / shift-vector side outputs (lines 137-196);
4. arbitrary-region block matching, bidirectional when >= 3 frames are
   buffered (:mod:`tpuflow.blockmatching`, lines 198-219);
5. per-pixel refinement around the BM prediction: either the
   region-gated robust gradient method (Mode OPTICALFLOW, lines 367-590)
   or per-region affine parametric motion (Mode AFFINE,
   Affine_BlockMatching.cpp:12-199);
6. compose BM vector + refinement into (u, v, t) with time direction
   t in {-1, +1} (Vector_ST, lines 306-361).

All dense compute (gradients, dt-under-warp, IRLS sweeps, affine moment
reductions) is jitted; the IRLS sweep is the same Jacobi stencil as
:mod:`tpuflow.solvers.black_anandan` plus a region gate and the
direction-coherence weight 0.5 * (1 + cos theta) (lines 486-509).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tpuflow.core.color import LAB_SCALE, srgb_to_lab
from tpuflow.core.config import (
    MODE_OUTPUT_AFFINE_BLOCKMATCHING,
    MultipleMotionParam,
)
from tpuflow.segmentation import SegmentationResult, segment_meanshift
from tpuflow.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho

LAMBDA_D = 5.0
LAMBDA_S = 1.0

#: Named driver profiles (the ``profile=`` argument of
#: :func:`optical_flow_block_matching`). ``"faithful"`` (== None) keeps
#: every default bit-faithful to the reference's exhaustive search and
#: over-damped refinement.
#:
#: ``"fast"`` is the quality-guarded speed operating point (round-5
#: corpus ablation, BASELINE.md at commit 8b855a1): the full-res
#: stride-2 coarse search
#: (``matmul_coarse``, -0.07 dB corpus) + the analytic Geman-McClure
#: Lipschitz bound with a 0.1%-per-64-sweeps plateau stop and a
#: 1024-sweep cap in the gradient refinement (measured 0.00 dB — the
#: reference's 2048-sweep over-damped budget mostly burns plateau).
#:
#: ``"quality"`` keeps the exhaustive search and reference refinement
#: but segments on the anti-aliased half-res frame (``seg_scale=2``):
#: the mean-shift converges to ~1.6x MORE regions there (2918 vs 1796
#: on 000050_10), and the finer piecewise-constant flow measured
#: +1.0 dB corpus compensation over the full-res default — ABOVE cv2
#: Farneback's corpus mean (22.82 vs 22.02, beating it on 42/61 pairs;
#: BASELINE.md at commit 8b855a1, r5). Slower (the one-hot search
#: scales with the wider region bucket).
#:
#: ``"turbo"`` combines the quality profile's fine segmentation with
#: the fast profile's coarse search + plateau refinement — measured
#: per-corpus in BASELINE.md at commit 8b855a1, round 5.
PROFILES = {
    "faithful": {},
    "fast": {
        "bm_method": "matmul_coarse",
        "refine_sup_mode": "analytic",
        "refine_plateau_rtol": 1.0e-3,
        "refine_iter_max": 1024,
    },
    "quality": {
        "seg_scale": 2,
    },
    "turbo": {
        "bm_method": "matmul_coarse",
        "refine_sup_mode": "analytic",
        "refine_plateau_rtol": 1.0e-3,
        "refine_iter_max": 1024,
        "seg_scale": 2,
    },
}
SIGMA_D_BM = 0.2 / math.sqrt(2.0)   # OpticalFlow_BlockMatching.cpp:47
SIGMA_S_BM = 0.03 / math.sqrt(2.0)  # OpticalFlow_BlockMatching.cpp:48
SIGMA_AFFINE_BM = 0.2 / math.sqrt(2.0)  # Affine_BlockMatching.cpp:17
HISTORY_MAX = 4


# ---------------------------------------------------------------------------
# Gradients and dt under the BM warp (mirror borders)


def _mirror_shift(img: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """img.get_mirror(x + dx, y + dy) for small static offsets."""
    h, w = img.shape
    xs = jnp.arange(w) + dx
    ys = jnp.arange(h) + dy
    xs = jnp.where(xs >= w, 2 * w - 2 - xs, jnp.abs(xs))
    ys = jnp.where(ys >= h, 2 * h - 2 - ys, jnp.abs(ys))
    return img[ys][:, xs]


@jax.jit
def gradient_method_grad(interest_l: jnp.ndarray):
    """2x2 forward-difference gradient of the interest frame's L channel
    (OpticalFlow_BlockMatching.cpp:372-384)."""
    i00 = interest_l
    i10 = _mirror_shift(interest_l, 1, 0)
    i01 = _mirror_shift(interest_l, 0, 1)
    i11 = _mirror_shift(interest_l, 1, 1)
    gx = ((i10 - i00) + (i11 - i01)) / 2.0
    gy = ((i01 - i00) + (i11 - i10)) / 2.0
    return gx, gy


@jax.jit
def gradient_method_dt(reference_l: jnp.ndarray, interest_l: jnp.ndarray,
                       mv_u: jnp.ndarray, mv_v: jnp.ndarray):
    """4-tap temporal difference under the floor(MV) warp
    (OpticalFlow_BlockMatching.cpp:385-397)."""
    h, w = reference_l.shape
    xs = jnp.arange(w)[None, :]
    ys = jnp.arange(h)[:, None]
    xt = xs + jnp.floor(mv_u).astype(jnp.int32)
    yt = ys + jnp.floor(mv_v).astype(jnp.int32)

    def mirror(i, n):
        i = jnp.abs(i)
        period = 2 * n - 2 if n > 1 else 1
        i = i % period
        return jnp.where(i >= n, period - i, i)

    def ref_at(ddx, ddy):
        return reference_l[mirror(yt + ddy, h), mirror(xt + ddx, w)]

    def int_at(ddx, ddy):
        return _mirror_shift(interest_l, ddx, ddy)

    return (ref_at(0, 0) - int_at(0, 0)
            + ref_at(1, 0) - int_at(1, 0)
            + ref_at(0, 1) - int_at(0, 1)
            + ref_at(1, 1) - int_at(1, 1)) / 4.0


@jax.jit
def gradient_method_dt_zero(reference_l: jnp.ndarray,
                            interest_l: jnp.ndarray):
    """:func:`gradient_method_dt` specialized to MV == 0 (the flagship's
    gradient branch zeroes MV before refinement,
    OpticalFlow_BlockMatching.cpp:291-293): the floor-warp gather
    degenerates to static mirror shifts — no gather op, so it runs at
    shift speed and partitions cleanly under GSPMD (a gather
    would force an all-gather of the reference tile). Bitwise-identical
    op order to the general path with zero MV."""

    def at(img, ddx, ddy):
        return _mirror_shift(img, ddx, ddy)

    return (at(reference_l, 0, 0) - at(interest_l, 0, 0)
            + at(reference_l, 1, 0) - at(interest_l, 1, 0)
            + at(reference_l, 0, 1) - at(interest_l, 0, 1)
            + at(reference_l, 1, 1) - at(interest_l, 1, 1)) / 4.0


# ---------------------------------------------------------------------------
# Region-gated IRLS (OpticalFlow_GradientMethod)


def _shift_field(f: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    return jnp.roll(f, shift=(-dy, -dx), axis=(-2, -1))


_NEIGHBOR_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _region_gates(labels, dt):
    """Iteration-invariant neighbor gates — in-bounds AND same-region,
    one (H, W) float mask per neighbor offset. The IRLS while-loops
    precompute these ONCE: recomputing the shifted labels + bounds masks
    inside every Jacobi sweep was pure loop-invariant work XLA does not
    hoist out of while bodies."""
    h, w = labels.shape[-2:]
    gates = []
    for dx, dy in _NEIGHBOR_OFFSETS:
        ln = _shift_field(labels, dx, dy)
        inb = jnp.ones((h, w), bool)
        if dx == 1:
            inb = inb.at[:, w - 1].set(False)
        elif dx == -1:
            inb = inb.at[:, 0].set(False)
        if dy == 1:
            inb = inb.at[h - 1, :].set(False)
        elif dy == -1:
            inb = inb.at[0, :].set(False)
        gates.append((inb & (ln == labels)).astype(dt))
    return gates


def _neighbor_terms(u, v, labels, sigma_s, gates=None):
    """Region-gated, direction-coherence-weighted neighbor sums
    (Error_u_Block, OpticalFlow_BlockMatching.cpp:465-514).

    coeff = 0.5 * (1 + u.un / (|u| |un|)); where either vector is zero the
    cosine is undefined (the reference divides 0/0) — we take coeff = 1
    (identical vectors are fully coherent), which is the zero-field limit.

    ``u``/``v`` may carry leading batch axes (the bidirectional refine
    batches both time directions into one program); ``labels`` stays 2-D
    and broadcasts. ``gates`` takes the precomputed
    :func:`_region_gates`. The neighbor norm is the ROLLED center norm
    (bitwise-identical to recomputing sqrt on the rolled fields — same
    values, shifted), saving 4 sqrt per sweep.
    """
    dt = u.dtype
    if gates is None:
        gates = _region_gates(labels, dt)
    norm_c = jnp.sqrt(u * u + v * v)
    nx = jnp.zeros_like(u)
    ny = jnp.zeros_like(v)
    for (dx, dy), gate in zip(_NEIGHBOR_OFFSETS, gates):
        un = _shift_field(u, dx, dy)
        vn = _shift_field(v, dx, dy)
        nn = _shift_field(norm_c, dx, dy)
        prod = norm_c * nn
        cosang = jnp.where(prod > 0, (u * un + v * vn) / jnp.maximum(prod, 1e-30), 1.0)
        coeff = 0.5 * (1.0 + cosang)
        m = gate * coeff
        nx = nx + m * geman_mcclure_psi(u - un, sigma_s)
        ny = ny + m * geman_mcclure_psi(v - vn, sigma_s)
    return nx, ny


def _neighbor_energy(u, v, labels, sigma_s, gates=None):
    dt = u.dtype
    if gates is None:
        gates = _region_gates(labels, dt)
    norm_c = jnp.sqrt(u * u + v * v)
    E = jnp.zeros_like(u)
    for (dx, dy), gate in zip(_NEIGHBOR_OFFSETS, gates):
        un = _shift_field(u, dx, dy)
        vn = _shift_field(v, dx, dy)
        nn = _shift_field(norm_c, dx, dy)
        prod = norm_c * nn
        cosang = jnp.where(prod > 0, (u * un + v * vn) / jnp.maximum(prod, 1e-30), 1.0)
        coeff = 0.5 * (1.0 + cosang)
        m = gate * coeff
        E = E + m * (geman_mcclure_rho(u - un, sigma_s)
                     + geman_mcclure_rho(v - vn, sigma_s))
    return E


def _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
               sup_mode: str = "reference"):
    """Lipschitz bound for the region-gated IRLS (sup_Error_uu_Block,
    OpticalFlow_BlockMatching.cpp:517-537). The reference's bound
    divides by sigma^2 where the Geman-McClure psi convention it uses
    has max curvature 2/sigma — the same ~over-damping the BA audit
    exposed (black_anandan.irls_sup): at the flagship sigmas the
    smoothness part is ~24x and the data part ~3.5x too conservative,
    so the 2048-iteration refinement budget barely moves the field.
    ``sup_mode="analytic"`` takes the true bound (gate*coeff <= 1 per
    neighbor) — same minimizer, provably monotone, several-fold the
    descent rate. Default keeps bit parity with the reference."""
    if sup_mode == "analytic":
        dt = gx.dtype
        sup_x = jnp.asarray(
            lambda_d * jnp.max(gx * gx) * (2.0 / sigma_d)
            + 4.0 * lambda_s * (2.0 / sigma_s)).astype(dt)
        sup_y = jnp.asarray(
            lambda_d * jnp.max(gy * gy) * (2.0 / sigma_d)
            + 4.0 * lambda_s * (2.0 / sigma_s)).astype(dt)
        return sup_x, sup_y
    if sup_mode != "reference":
        raise ValueError(f"unknown sup_mode {sup_mode!r}")
    sup_x = (lambda_d * jnp.max(gx * gx) / sigma_d**2
             + 4.0 * lambda_s / sigma_s**2)
    sup_y = (lambda_d * jnp.max(gy * gy) / sigma_d**2
             + 4.0 * lambda_s / sigma_s**2)
    return sup_x, sup_y


@partial(jax.jit, static_argnames=("iter_max", "sup_mode",
                                   "plateau_rtol"))
def irls_gradient_method(
    gx, gy, it, labels,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float,
    u0=None, v0=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """IRLS_OpticalFlow_GradientMethod (OpticalFlow_BlockMatching.cpp:
    412-462): Jacobi sweeps with the region-gated neighbor term, energy
    check every 64 iterations, 3-strikes divergence stop.

    Returns (u, v, E, n, trace): ``trace[k]`` = E after the sweep with
    n == 64 k (the E(n) telemetry cadence, OpticalFlow.cpp:261-265);
    NaN past the stopping point. ``sup_mode``: see :func:`_gated_sup`.

    ``plateau_rtol > 0`` adds a convergence stop the reference lacks
    (its only stops are the absolute threshold and the 3-strikes
    divergence counter, so a MONOTONE descent always burns the full
    budget): stop once a 64-iteration check window improves the energy
    by less than ``plateau_rtol`` relative. The fast profile pairs it
    with ``sup_mode="analytic"`` (provably monotone, several-fold the
    descent rate — the budget is mostly plateau there)."""
    sup_x, sup_y = _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d,
                              sigma_s, sup_mode)
    n_checks = max(-(-iter_max // 64), 1)
    gates = _region_gates(labels, gx.dtype)

    def energy(u, v):
        center = geman_mcclure_rho(gx * u + gy * v + it, sigma_d)
        return jnp.sum(lambda_d * center
                       + lambda_s * _neighbor_energy(u, v, labels, sigma_s,
                                                     gates))

    def cond(carry):
        u, v, E, Eprev, inc, n, stop, trace = carry
        return jnp.logical_and(n < iter_max, jnp.logical_not(stop))

    def body(carry):
        u, v, E, Eprev, inc, n, _, trace = carry
        psi_d = geman_mcclure_psi(gx * u + gy * v + it, sigma_d)
        nx, ny = _neighbor_terms(u, v, labels, sigma_s, gates)
        u = u - (lambda_d * gx * psi_d + lambda_s * nx) / sup_x
        v = v - (lambda_d * gy * psi_d + lambda_s * ny) / sup_y

        def check(args):
            u, v, E, Eprev, inc = args
            E_new = energy(u, v)
            inc_new = jnp.where(E_new > E, inc + 1, 0)
            return E, E_new, inc_new

        do_check = (n & 0x3F) == 0
        Eprev2, E2, inc2 = jax.lax.cond(
            do_check, check, lambda args: (args[3], args[2], args[4]),
            (u, v, E, Eprev, inc))
        trace = jax.lax.cond(
            do_check, lambda: trace.at[n >> 6].set(E2), lambda: trace)
        should_stop = jnp.logical_or(E2 < error_min_threshold, inc2 > 3)
        if plateau_rtol > 0.0:
            # Eprev2 carries the PREVIOUS check's energy (0 before the
            # first check, so the plateau can't fire there).
            should_stop = jnp.logical_or(
                should_stop,
                jnp.logical_and(Eprev2 > 0,
                                E2 >= (1.0 - plateau_rtol) * Eprev2))
        stop = jnp.logical_and(do_check, should_stop)
        return u, v, E2, Eprev2, inc2, n + 1, stop, trace

    z_u = jnp.zeros_like(gx) if u0 is None else u0
    z_v = jnp.zeros_like(gx) if v0 is None else v0
    E0 = jnp.asarray(0.0, gx.dtype)
    trace0 = jnp.full((n_checks,), jnp.nan, gx.dtype)
    u, v, E, _, _, n, _, trace = jax.lax.while_loop(
        cond, body,
        (z_u, z_v, E0, E0, jnp.int32(0), jnp.int32(0), jnp.bool_(False),
         trace0))
    return u, v, E, n, trace


@partial(jax.jit, static_argnames=("iter_max", "sup_mode",
                                   "plateau_rtol"))
def irls_gradient_method_batched(
    gx, gy, its, labels,
    lambda_d: float, lambda_s: float, sigma_d: float, sigma_s: float,
    iter_max: int, error_min_threshold: float,
    u0=None, v0=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """:func:`irls_gradient_method` over a batch of temporal-difference
    fields sharing one interest frame (gx/gy/labels): the flagship's
    bidirectional refine (OpticalFlow_BlockMatching.cpp:84-93 runs the
    gradient method once per time direction) issues BOTH directions'
    Jacobi chains in a single program, so the two independent dependent
    chains interleave on the VPU instead of paying the per-op issue
    latency serially twice.

    ``its``: (B, H, W). Each batch element keeps the serial semantics —
    per-element energy, 3-strikes counter and early stop (a stopped
    element's fields freeze while the others run on). Returns
    (u, v, E, n, trace) with leading batch axes (trace: (B, n_checks),
    NaN past each element's stopping point)."""
    sup_x, sup_y = _gated_sup(gx, gy, lambda_d, lambda_s, sigma_d,
                              sigma_s, sup_mode)
    n_checks = max(-(-iter_max // 64), 1)
    batch = its.shape[0]
    gates = _region_gates(labels, gx.dtype)

    def energy(u, v):
        center = geman_mcclure_rho(gx * u + gy * v + its, sigma_d)
        return jnp.sum(lambda_d * center
                       + lambda_s * _neighbor_energy(u, v, labels, sigma_s,
                                                     gates),
                       axis=(-2, -1))

    def cond(carry):
        u, v, E, Eprev, inc, n, stop, trace = carry
        return jnp.logical_and(n < iter_max, jnp.logical_not(jnp.all(stop)))

    def body(carry):
        u, v, E, Eprev, inc, n, stop, trace = carry
        psi_d = geman_mcclure_psi(gx * u + gy * v + its, sigma_d)
        nx, ny = _neighbor_terms(u, v, labels, sigma_s, gates)
        active = jnp.logical_not(stop)[:, None, None]
        u = jnp.where(active,
                      u - (lambda_d * gx * psi_d + lambda_s * nx) / sup_x, u)
        v = jnp.where(active,
                      v - (lambda_d * gy * psi_d + lambda_s * ny) / sup_y, v)

        def check(args):
            u, v, E, Eprev, inc, stop, trace = args
            E_new = jnp.where(stop, E, energy(u, v))
            inc_new = jnp.where(stop, inc,
                                jnp.where(E_new > E, inc + 1, 0))
            trace = trace.at[:, n >> 6].set(
                jnp.where(stop, trace[:, n >> 6], E_new))
            stop_new = stop | (E_new < error_min_threshold) | (inc_new > 3)
            if plateau_rtol > 0.0:
                # E carries the previous check's energy per element (0
                # before the first check — the plateau can't fire there).
                stop_new = stop_new | (
                    (E > 0) & (E_new >= (1.0 - plateau_rtol) * E))
            return E, E_new, inc_new, stop_new, trace

        do_check = (n & 0x3F) == 0
        Eprev2, E2, inc2, stop2, trace = jax.lax.cond(
            do_check, check,
            lambda args: (args[3], args[2], args[4], args[5], args[6]),
            (u, v, E, Eprev, inc, stop, trace))
        return u, v, E2, Eprev2, inc2, n + 1, stop2, trace

    shape = its.shape
    z_u = jnp.zeros(shape, gx.dtype) if u0 is None else u0
    z_v = jnp.zeros(shape, gx.dtype) if v0 is None else v0
    E0 = jnp.zeros((batch,), gx.dtype)
    trace0 = jnp.full((batch, n_checks), jnp.nan, gx.dtype)
    u, v, E, _, _, n, _, trace = jax.lax.while_loop(
        cond, body,
        (z_u, z_v, E0, E0, jnp.zeros((batch,), jnp.int32), jnp.int32(0),
         jnp.zeros((batch,), bool), trace0))
    return u, v, E, n, trace


def gradient_method_flow(
    reference_lab: jnp.ndarray,
    interest_lab: jnp.ndarray,
    mv_u: jnp.ndarray,
    mv_v: jnp.ndarray,
    labels: jnp.ndarray,
    lambda_d: float = LAMBDA_D,
    lambda_s: float = LAMBDA_S,
    sigma_d: float = SIGMA_D_BM,
    sigma_s: float = SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    u0=None,
    v0=None,
    zero_warp: bool = False,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """OpticalFlow_GradientMethod (OpticalFlow_BlockMatching.cpp:367-409).

    NOTE: the reference zeroes MV before refinement ("for DEBUG",
    lines 291-293) — callers decide whether to warp (pass zeros to
    reproduce the reference exactly; ``zero_warp=True`` additionally
    routes the dt through the gather-free specialization
    :func:`gradient_method_dt_zero`). ``u0``/``v0`` warm-start the IRLS
    (streaming pipelines; the reference always starts from zero).
    """
    # Gradients/dt in STANDARD Lab units: the reference's robust
    # constants (sigma_d = 0.2/sqrt(2), sigma_s = 0.03/sqrt(2),
    # OpticalFlow_BlockMatching.cpp:47-48) are tuned against the missing
    # ImgClass Lab's L in [0, 100]; tpuflow's normalized Lab would
    # shrink every data residual ~100x against them.
    interest_l = interest_lab[..., 0] * LAB_SCALE
    reference_l = reference_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    if zero_warp:
        it = gradient_method_dt_zero(reference_l, interest_l)
    else:
        it = gradient_method_dt(reference_l, interest_l, mv_u, mv_v)
    u, v, _, _, trace = irls_gradient_method(
        gx, gy, it, jnp.asarray(labels),
        lambda_d, lambda_s, sigma_d, sigma_s,
        int(iter_max), error_min_threshold, u0, v0,
        sup_mode=sup_mode, plateau_rtol=float(plateau_rtol))
    from tpuflow.solvers.black_anandan import _emit_energy_trace

    _emit_energy_trace(0, trace)
    return u, v


def gradient_method_flow_bidirectional(
    reference_labs,
    interest_lab: jnp.ndarray,
    labels: jnp.ndarray,
    lambda_d: float = LAMBDA_D,
    lambda_s: float = LAMBDA_S,
    sigma_d: float = SIGMA_D_BM,
    sigma_s: float = SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    mvs=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
):
    """Both time directions of the flagship's gradient refine
    (OpticalFlow_BlockMatching.cpp:84-93 + 367-409, zero-MV branch
    291-293) in ONE device program via
    :func:`irls_gradient_method_batched`: gx/gy/labels are shared (they
    belong to the interest frame), only dt differs per direction, and
    batching the two Jacobi chains interleaves their per-op issue
    latency instead of paying it twice serially.

    ``reference_labs``: sequence of B reference Lab frames. Returns a
    list of B (u, v) pairs in the same order, each bitwise equal to the
    serial :func:`gradient_method_flow` call with ``zero_warp=True``.

    ``mvs`` (optional sequence of B (H, W, 2) per-pixel BM fields)
    switches each direction's dt to the non-debug BM warp
    (gradient_method_dt — the driver's ``refine_warp=True`` lever);
    each direction then matches the serial call with that MV."""
    # Standard Lab units — see gradient_method_flow.
    interest_l = interest_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    if mvs is None:
        its = jnp.stack([gradient_method_dt_zero(r[..., 0] * LAB_SCALE,
                                                 interest_l)
                         for r in reference_labs])
    else:
        its = jnp.stack([
            gradient_method_dt(r[..., 0] * LAB_SCALE, interest_l,
                               mv[..., 0], mv[..., 1])
            for r, mv in zip(reference_labs, mvs)])
    u, v, _, _, trace = irls_gradient_method_batched(
        gx, gy, its, jnp.asarray(labels),
        lambda_d, lambda_s, sigma_d, sigma_s,
        int(iter_max), error_min_threshold, sup_mode=sup_mode,
        plateau_rtol=float(plateau_rtol))
    from tpuflow.solvers.black_anandan import _emit_energy_trace

    for b in range(len(reference_labs)):
        _emit_energy_trace(0, trace[b])
    return [(u[b], v[b]) for b in range(len(reference_labs))]


# ---------------------------------------------------------------------------
# Per-region affine parametric motion (AffineParametric)


@partial(jax.jit, static_argnames=("n_regions", "iter_max",
                                   "normalize_steps"))
def _irls_affine_regions(gx, gy, it, labels, n_regions: int,
                         sigma: float, iter_max: int,
                         error_min_threshold: float,
                         normalize_steps: bool = False,
                         a0=None):
    """All regions' 6-parameter IRLS at once: the per-region moment sums
    are segment reductions, the parameter update is elementwise over the
    (n_regions, 6) table (IRLS_AffineParametric_region,
    Affine_BlockMatching.cpp:84-116; omega = 1.0)."""
    h, w = gx.shape
    dt = gx.dtype
    x = jnp.arange(w, dtype=dt)[None, :] * jnp.ones((h, 1), dt)
    y = jnp.arange(h, dtype=dt)[:, None] * jnp.ones((1, w), dt)
    basis = jnp.stack([gx, gx * x, gx * y, gy, gy * x, gy * y], axis=0)
    flat = labels.reshape(-1)

    def seg(f):
        return jax.ops.segment_sum(f.reshape(-1), flat,
                                   num_segments=n_regions)

    def seg_max(f):
        return jax.ops.segment_max(f.reshape(-1), flat,
                                   num_segments=n_regions)

    # sup_i per region: 2 * max_site (basis_i^2) / sigma^2
    # (sup_Error_aa_region).
    sup = jnp.stack([2.0 * seg_max(basis[i] ** 2) / sigma**2
                     for i in range(6)], axis=-1)  # (n_regions, 6)
    omega = 1.0
    tiny = jnp.abs(sup) < 1.0e-10
    step = jnp.where(tiny, omega * 1.0e10 * jnp.where(sup >= 0, 1.0, -1.0),
                     omega / jnp.where(tiny, 1.0, sup))
    if normalize_steps:
        # Stabilized extension (not in the reference): the gradient dE is
        # a *sum* over the region while sup is a per-site max, so the
        # reference's omega=1 step overshoots on regions much larger than
        # its typical mean-shift segments. Dividing by the region size
        # restores a mean-gradient step.
        counts = jax.ops.segment_sum(jnp.ones_like(flat, dtype=dt), flat,
                                     num_segments=n_regions)
        step = step / jnp.maximum(counts, 1.0)[:, None]

    def flow_of(a):
        a_pix = a[labels]  # (H, W, 6)
        u = a_pix[..., 0] + a_pix[..., 1] * x + a_pix[..., 2] * y
        v = a_pix[..., 3] + a_pix[..., 4] * x + a_pix[..., 5] * y
        return u, v

    def energy_of(a):
        u, v = flow_of(a)
        r = geman_mcclure_rho(gx * u + gy * v + it, sigma)
        return seg(r)  # (n_regions,)

    def body(n, carry):
        a, done = carry
        u, v = flow_of(a)
        psi = geman_mcclure_psi(gx * u + gy * v + it, sigma)
        dE = jnp.stack([seg(basis[i] * psi) for i in range(6)], axis=-1)
        a_new = a - step * dE
        a = jnp.where(done[:, None], a, a_new)
        E = energy_of(a)
        done = jnp.logical_or(done, E < error_min_threshold)
        return a, done

    if a0 is None:
        a0 = jnp.zeros((n_regions, 6), dt)
    done0 = jnp.zeros((n_regions,), bool)
    a, _ = jax.lax.fori_loop(0, iter_max, body, (a0, done0))
    u, v = flow_of(a)
    return a, u, v


def affine_parametric_flow(
    reference_lab: jnp.ndarray,
    interest_lab: jnp.ndarray,
    mv_u: jnp.ndarray,
    mv_v: jnp.ndarray,
    labels: np.ndarray,
    n_regions: int,
    sigma: float = SIGMA_AFFINE_BM,
    iter_max: int = 256,
    error_min_threshold: float = 1.0e-6,
    normalize_steps: bool = False,
    a0=None,
):
    """AffineParametric (Affine_BlockMatching.cpp:11-77): per-region
    6-parameter robust fit of the residual motion under the BM warp.
    Returns (a (n_regions, 6), u, v).

    ``normalize_steps=True`` selects the stabilized step (mean gradient
    instead of the reference's summed gradient); False reproduces the
    reference exactly — which DIVERGES on mean-shift-sized regions (the
    per-parameter gradient is a SUM of N site terms while the Lipschitz
    sup is a per-site max, so the omega=1 step overshoots by ~N;
    measured EPE 17 vs a 2.6-px true flow on a synthetic affine pair,
    against 1.0 with the stabilized step). The flagship driver defaults
    to the stabilized step.
    """
    # Standard Lab units — see gradient_method_flow.
    interest_l = interest_lab[..., 0] * LAB_SCALE
    gx, gy = gradient_method_grad(interest_l)
    it = gradient_method_dt(reference_lab[..., 0] * LAB_SCALE, interest_l,
                            jnp.asarray(mv_u), jnp.asarray(mv_v))
    # Bucket the static region count (like the block matcher) so
    # frame-to-frame segmentation drift reuses the compiled IRLS.
    from tpuflow.blockmatching.matcher import region_bucket

    n_pad = region_bucket(int(n_regions))
    if a0 is not None and a0.shape[0] < n_pad:
        a0 = jnp.concatenate(
            [jnp.asarray(a0),
             jnp.zeros((n_pad - a0.shape[0], 6), gx.dtype)], axis=0)
    a, u, v = _irls_affine_regions(gx, gy, it, jnp.asarray(labels),
                                   n_pad, float(sigma), int(iter_max),
                                   error_min_threshold, normalize_steps, a0)
    return a[: int(n_regions)], u, v


# ---------------------------------------------------------------------------
# Device-side Vector_ST composition (OpticalFlow_BlockMatching.cpp:306-361)
#
# The per-region (u, v, cost) triples expand to per-pixel maps with ONE
# row gather from a packed (n_regions, 3) table, and the time-direction
# select + BM-plus-refinement add run as device ops. Composing on device
# keeps the whole tail queued behind the searches/refines; the host
# fetches only the five final fields (the numpy fancy-index expansion
# this replaces cost ~1 s/frame of serial host time at KITTI res).


@jax.jit
def _compose_bidirectional(labels, table_p, table_n, ru_p, rv_p, ru_n,
                           rv_n):
    g_p = table_p[labels]  # (H, W, 3) row gather: [u, v, cost]
    g_n = table_n[labels]
    neg = g_p[..., 2] <= g_n[..., 2]
    t = jnp.where(neg, jnp.int8(-1), jnp.int8(1))
    u_bm = jnp.where(neg, g_p[..., 0], g_n[..., 0])
    v_bm = jnp.where(neg, g_p[..., 1], g_n[..., 1])
    u_out = u_bm + jnp.where(neg, ru_p, ru_n)
    v_out = v_bm + jnp.where(neg, rv_p, rv_n)
    return u_out, v_out, t, u_bm, v_bm


@jax.jit
def _compose_unidirectional(labels, table_p, ru, rv):
    g = table_p[labels]
    u_bm = g[..., 0]
    v_bm = g[..., 1]
    return u_bm + ru, v_bm + rv, u_bm, v_bm


# ---------------------------------------------------------------------------
# Driver with explicit history state


@dataclass
class BMFlowState:
    """The reference's static deques made explicit (newest first)."""

    lab_frames: list = field(default_factory=list)
    rgb_frames: list = field(default_factory=list)
    segmentations: list = field(default_factory=list)

    def push(self, lab, rgb, seg):
        self.lab_frames.insert(0, lab)
        self.rgb_frames.insert(0, rgb)
        self.segmentations.insert(0, seg)
        # History_Max = 4 (OpticalFlow_BlockMatching.cpp:16-22: pop only
        # when the deque would exceed 4 frames).
        if len(self.lab_frames) > HISTORY_MAX:
            self.lab_frames.pop()
            self.rgb_frames.pop()
            self.segmentations.pop()


@dataclass
class BMFlowOutput:
    u: np.ndarray            # (H, W) composed flow x
    v: np.ndarray            # (H, W)
    t: np.ndarray            # (H, W) int8 time direction in {-1, +1}
    segmentation: SegmentationResult
    quantized_rgb: np.ndarray        # (H, W, 3) uint8 side output
    shift_vector: np.ndarray         # (H, W, 2) mean-shift spatial shifts
    bm_u: np.ndarray
    bm_v: np.ndarray
    # True when >= 3 frames were buffered, i.e. the motion belongs to the
    # *middle* frame and the caller must write it under the previous
    # frame's output name (Scratch_MeaningfulMotion.cpp:544-552).
    bidirectional: bool = False


def _quantize_colors(rgb_norm: np.ndarray, seg: SegmentationResult) -> np.ndarray:
    """Per-region mean color, x255, clipped (the color-quantized side
    output, OpticalFlow_BlockMatching.cpp:154-181)."""
    h, w = seg.labels.shape
    flat = seg.labels.reshape(-1)
    sums = np.zeros((seg.n_regions, 3))
    np.add.at(sums, flat, rgb_norm.reshape(-1, 3))
    counts = np.maximum(np.bincount(flat, minlength=seg.n_regions), 1)
    means = np.clip(sums / counts[:, None] * 255.0, 0, 255)
    return means[seg.labels].astype(np.uint8)


def optical_flow_block_matching_async(
    it_rgb: np.ndarray,
    itp1_rgb: np.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    mode: int = 0,
    iter_max: int = 2048,
    state: BMFlowState | None = None,
    search_range: int = 61,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    subpixel_scale: int = 2,
    mesh=None,
    bm_method: str = "matmul",
    refine_warp: bool = False,
    affine_normalize_steps: bool = True,
    refine_sup_mode: str = "reference",
    refine_plateau_rtol: float = 0.0,
    seg_scale: int = 1,
    profile: str | None = None,
):
    """The flagship driver, split into dispatch + deferred fetch.

    ``seg_scale > 1`` runs the mean-shift segmentation on the
    stride-``seg_scale`` subsampled frame (kernel extents scaled to
    match) and replicates labels back — ~scale^4 less filter work; NOT
    faithful (quality-guarded at corpus level). Single-device only.

    ``profile`` selects a named knob bundle (:data:`PROFILES`):
    ``"fast"`` overrides ``bm_method``/``refine_sup_mode``/
    ``refine_plateau_rtol`` and caps ``iter_max`` for the documented
    speed operating point; ``"faithful"``/None changes nothing.

    ``refine_plateau_rtol > 0`` stops the gradient refinement once a
    64-iteration energy-check window improves less than that relative
    fraction (see :func:`irls_gradient_method`).

    ``refine_sup_mode="analytic"`` takes the true Geman-McClure
    Lipschitz bound in the gradient refinement (see
    :func:`_gated_sup`) — several-fold the descent rate within the
    same iteration budget; default keeps the reference's over-damped
    step for bit parity.

    ``affine_normalize_steps`` selects the per-region affine IRLS step
    (mode=AFFINE only): True (default) = the stabilized mean-gradient
    step (the reference's summed-gradient omega=1 step diverges on
    mean-shift-sized regions, docs/MIGRATION.md); False = the
    reference's literal step for parity studies.

    ``refine_warp=True`` feeds the gradient-method refinement the REAL
    per-pixel BM field instead of zeros: the reference zeroes MV before
    the gradient refine "for DEBUG" (OpticalFlow_BlockMatching.cpp:
    291-293) and the default reproduces that, but the non-debug math —
    dt under the BM warp (gradient_method_dt, :385-397), refinement as
    a correction on the warped residual — is the un-commented intent.
    Quality sweep: scripts/corpus_psnr.py
    --refine_warp. Composes with ``mesh`` (the warped dt is computed
    once on the full frames and fed into the sharded refine —
    dist/bm_refine.py external_dt).

    Returns ``(finalize, state)``: every device stage is dispatched and
    all per-frame host work is done; ``finalize()`` fetches the composed
    fields and builds the :class:`BMFlowOutput`. The returned ``state``
    is ready IMMEDIATELY, so a sequence loop dispatches frame i+1
    before finalizing frame i — the next frame's mean-shift filter and
    searches queue behind this frame's refines, hiding the output fetch
    and the next frame's host labeling behind device work
    (:func:`optical_flow_block_matching` is the synchronous wrapper).

    Flow semantics: INVERSE flow — vectors point from current-frame
    pixels to where they came from/go to in the reference frame, with
    t = -1 (previous) or +1 (next).

    ``mesh`` (a ("ty", "tx") jax.sharding.Mesh; image dims must divide
    it) runs every device stage multi-chip: the mean-shift filter tiled
    with halo exchange, the BM searches candidate-parallel, and the
    gradient-method refinement tiled with fused ppermute halos, and the
    affine refinement with psum'd per-region moment reductions
    (tpuflow.dist). The host labeling is global either way.

    ``bm_method`` selects the search evaluator (matcher.py):
    ``"matmul"`` (default, bit-faithful f32), ``"matmul_bf16"`` (bf16
    matmul inputs + f32 accumulation; integer winners can differ at
    near-ties, the subpixel re-score stays f32), or ``"gather"``.

    Steady-state pipelining: the bidirectional match + refinement run on
    the *middle* frame with the segmentation computed on the PREVIOUS
    call, so the new frame's segmentation is independent of them. The
    driver dispatches the new frame's mean-shift filter first, queues
    every search/refine behind it, and only then fetches the filter
    output — the host labeling (+ quantize/shift side outputs) runs
    while the device works through the queued matching (~1 s of host
    work hidden behind ~2 s of device work per frame at KITTI res).
    """
    from tpuflow.blockmatching.matcher import _match_device
    from tpuflow.segmentation import segment_meanshift_async

    if profile is not None:
        if profile not in PROFILES:
            raise ValueError(f"unknown profile {profile!r}; expected one "
                             f"of {sorted(PROFILES)}")
        knobs = PROFILES[profile]
        bm_method = knobs.get("bm_method", bm_method)
        refine_sup_mode = knobs.get("refine_sup_mode", refine_sup_mode)
        refine_plateau_rtol = knobs.get("refine_plateau_rtol",
                                        refine_plateau_rtol)
        if mesh is None:
            seg_scale = knobs.get("seg_scale", seg_scale)
        if "refine_iter_max" in knobs:
            iter_max = min(iter_max, knobs["refine_iter_max"])
    if param is None:
        param = MultipleMotionParam()
    if state is None:
        state = BMFlowState()

    def to_lab(rgb):
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        norm = jnp.asarray(rgb, jnp.float32) / max_int
        return norm, srgb_to_lab(norm)

    if not state.lab_frames:
        it_norm, it_lab = to_lab(np.asarray(it_rgb))
        seg_it = segment_meanshift(np.asarray(it_lab), kernel_spatial,
                                   kernel_intensity,
                                   scale=int(seg_scale))
        state.push(it_lab, np.asarray(it_norm), seg_it)
    itp1_norm, itp1_lab = to_lab(np.asarray(itp1_rgb))
    # Device filter dispatched FIRST; labeling deferred until the
    # matching work below is queued behind it.
    finalize_seg = segment_meanshift_async(itp1_lab, kernel_spatial,
                                           kernel_intensity, mesh=mesh,
                                           scale=int(seg_scale))

    if mesh is not None:
        from tpuflow.dist.bm import _match_device_sharded

        def match_dev(cur, ref, seg):
            return _match_device_sharded(
                cur, ref, seg.labels, seg.n_regions, mesh, search_range,
                1.0, 0.5, subpixel_scale, 16, bm_method)
    else:
        def match_dev(cur, ref, seg):
            return _match_device(cur, ref, seg.labels, seg.n_regions,
                                 search_range, 1.0, 0.5, subpixel_scale,
                                 16, bm_method)

    # With the new frame not yet pushed: state[0] = middle frame,
    # state[1] = previous-previous (the bidirectional refs,
    # OpticalFlow_BlockMatching.cpp:84-93).
    bidirectional = len(state.lab_frames) >= 2
    if bidirectional:
        interest_lab = state.lab_frames[0]
        seg = state.segmentations[0]
        ref_prev = state.lab_frames[1]
        ref_next = itp1_lab
        if bm_method.startswith("matmul"):
            # Both directions in ONE search program: the cur-side moment
            # fields and validity masks are shared (matcher.py
            # _integer_costs_matmul_bidi) — bitwise equal to the two
            # single-direction programs. Same fusion candidate-parallel
            # over a mesh (dist.bm).
            if mesh is None:
                from tpuflow.blockmatching.matcher import (
                    _match_device_bidirectional as match_bidi,
                )

                bm_dev = list(match_bidi(
                    interest_lab, ref_prev, ref_next, seg.labels,
                    seg.n_regions, search_range, 1.0, 0.5,
                    subpixel_scale, 16, bm_method))
            else:
                from tpuflow.dist.bm import (
                    _match_device_sharded_bidirectional,
                )

                bm_dev = list(_match_device_sharded_bidirectional(
                    interest_lab, ref_prev, ref_next, seg.labels,
                    seg.n_regions, mesh, search_range, 1.0, 0.5,
                    subpixel_scale, 16, bm_method))
        else:
            bm_dev = [match_dev(interest_lab, ref_prev, seg),
                      match_dev(interest_lab, ref_next, seg)]
    else:
        # First pair: the interest frame IS the new frame, so its
        # segmentation gates the match — finalize before dispatching
        # (cold path, once per sequence).
        seg_new = finalize_seg()
        finalize_seg = lambda: seg_new  # noqa: E731
        interest_lab = itp1_lab
        seg = seg_new
        ref_prev = state.lab_frames[0]
        bm_dev = [match_dev(interest_lab, ref_prev, seg)]

    labels_j = jnp.asarray(seg.labels)
    zeros = jnp.zeros_like(jnp.asarray(interest_lab)[..., 0])

    def refine(reference_lab, bm_uv):
        if mode == MODE_OUTPUT_AFFINE_BLOCKMATCHING:
            # AffineParametric receives the real per-pixel BM field —
            # the reference zeroes MV only in the gradient branch
            # (OpticalFlow_BlockMatching.cpp:278-304). Gathered on
            # device from the search output so the refine still queues
            # behind the search without a host sync.
            mv = bm_uv[labels_j]
            if mesh is not None:
                from tpuflow.dist.bm_refine import (
                    affine_parametric_flow_sharded,
                )

                # Static displacement bound from the search geometry
                # (subpixel adds < 1 px) keeps the dispatch sync-free.
                # normalize_steps: the reference's summed-gradient
                # omega=1 step diverges on mean-shift-sized regions
                # (see affine_parametric_flow) — the driver defaults to
                # the stabilized mean-gradient step.
                _, u, v = affine_parametric_flow_sharded(
                    reference_lab, interest_lab, mv[..., 0], mv[..., 1],
                    seg.labels, seg.n_regions, mesh,
                    iter_max=min(iter_max, 256),
                    error_min_threshold=param.error_min_threshold,
                    max_displacement=search_range // 2 + 1,
                    normalize_steps=affine_normalize_steps)
                return u, v
            _, u, v = affine_parametric_flow(
                reference_lab, interest_lab, mv[..., 0], mv[..., 1],
                seg.labels, seg.n_regions,
                iter_max=min(iter_max, 256),
                error_min_threshold=param.error_min_threshold,
                normalize_steps=affine_normalize_steps)
            return u, v
        # The reference zeroes MV before the gradient method
        # (OpticalFlow_BlockMatching.cpp:291-293) — reproduced here via
        # the gather-free zero-warp dt; refine_warp=True restores the
        # non-debug dt-under-BM-warp instead.
        if refine_warp and mesh is None:
            mv = bm_uv[labels_j]
            return gradient_method_flow(
                reference_lab, interest_lab, mv[..., 0], mv[..., 1],
                labels_j, iter_max=iter_max,
                error_min_threshold=param.error_min_threshold,
                sup_mode=refine_sup_mode,
                plateau_rtol=refine_plateau_rtol)
        if mesh is not None:
            from tpuflow.dist.bm_refine import gradient_method_flow_sharded
            from tpuflow.solvers.black_anandan import _emit_energy_trace

            u, v, trace = gradient_method_flow_sharded(
                reference_lab, interest_lab, seg.labels, mesh,
                iter_max=iter_max,
                error_min_threshold=param.error_min_threshold,
                mv=bm_uv[labels_j] if refine_warp else None,
                sup_mode=refine_sup_mode,
                plateau_rtol=refine_plateau_rtol)
            _emit_energy_trace(0, trace)
            return u, v
        return gradient_method_flow(
            reference_lab, interest_lab, zeros, zeros, labels_j,
            iter_max=iter_max,
            error_min_threshold=param.error_min_threshold,
            zero_warp=True, sup_mode=refine_sup_mode,
            plateau_rtol=refine_plateau_rtol)

    refs = [(ref_prev, bm_dev[0][0])]
    if bidirectional:
        refs.append((ref_next, bm_dev[1][0]))
    # Dispatch every refinement before fetching: searches + refines
    # queue back-to-back on device behind the mean-shift filter. The
    # bidirectional gradient refine batches both directions into ONE
    # program (the IRLS is per-op-latency-bound; two independent chains
    # interleave) — bitwise equal to the two serial calls.
    if bidirectional and mode != MODE_OUTPUT_AFFINE_BLOCKMATCHING:
        if mesh is None:
            mvs = ([bm_dev[0][0][labels_j], bm_dev[1][0][labels_j]]
                   if refine_warp else None)
            refined_dev = gradient_method_flow_bidirectional(
                [ref_prev, ref_next], interest_lab, labels_j,
                iter_max=iter_max,
                error_min_threshold=param.error_min_threshold, mvs=mvs,
                sup_mode=refine_sup_mode,
                plateau_rtol=refine_plateau_rtol)
        else:
            from tpuflow.dist.bm_refine import (
                gradient_method_flow_sharded_bidirectional,
            )
            from tpuflow.solvers.black_anandan import _emit_energy_trace

            mvs = ([bm_dev[0][0][labels_j], bm_dev[1][0][labels_j]]
                   if refine_warp else None)
            refined_dev, trace = (
                gradient_method_flow_sharded_bidirectional(
                    [ref_prev, ref_next], interest_lab, seg.labels,
                    mesh, iter_max=iter_max,
                    error_min_threshold=param.error_min_threshold,
                    mvs=mvs, sup_mode=refine_sup_mode,
                    plateau_rtol=refine_plateau_rtol))
            for b in range(2):
                _emit_energy_trace(0, trace[b])
    else:
        refined_dev = [refine(rl, duv) for rl, duv in refs]

    # Compose Vector_ST on device (BM vector + matching-direction
    # refinement, OpticalFlow_BlockMatching.cpp:307-331) — queued behind
    # the refines, so the host tail below overlaps ALL device work.
    def table(uv, cost):
        return jnp.concatenate([uv, cost[:, None]], axis=-1)

    if bidirectional:
        composed_dev = _compose_bidirectional(
            labels_j, table(*bm_dev[0]), table(*bm_dev[1]),
            refined_dev[0][0], refined_dev[0][1],
            refined_dev[1][0], refined_dev[1][1])
    else:
        composed_dev = _compose_unidirectional(
            labels_j, table(*bm_dev[0]),
            refined_dev[0][0], refined_dev[0][1])

    # Everything is queued — fetch the filter output (ready after the
    # first ~1 s of device work) and run the host labeling while the
    # device finishes the searches, refines and composition.
    seg_new = finalize_seg()
    state.push(itp1_lab, np.asarray(itp1_norm), seg_new)
    quantized = _quantize_colors(np.asarray(itp1_norm), seg_new)
    xy = np.mgrid[0 : seg.labels.shape[0], 0 : seg.labels.shape[1]]
    shift = np.stack([seg_new.shift_spatial[..., 0] - xy[1],
                      seg_new.shift_spatial[..., 1] - xy[0]], axis=-1)

    def finalize() -> BMFlowOutput:
        if bidirectional:
            u_out, v_out, t, u_bm, v_bm = jax.device_get(composed_dev)
        else:
            u_out, v_out, u_bm, v_bm = jax.device_get(composed_dev)
            t = np.full(seg.labels.shape, -1, np.int8)
        return BMFlowOutput(
            u=np.asarray(u_out), v=np.asarray(v_out), t=t,
            segmentation=seg,
            quantized_rgb=quantized,
            shift_vector=shift,
            bm_u=u_bm, bm_v=v_bm,
            bidirectional=bidirectional)

    return finalize, state


def optical_flow_block_matching(
    it_rgb: np.ndarray,
    itp1_rgb: np.ndarray,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    mode: int = 0,
    iter_max: int = 2048,
    state: BMFlowState | None = None,
    search_range: int = 61,
    kernel_spatial: int = 20,
    kernel_intensity: float = 16.0 / 255.0,
    subpixel_scale: int = 2,
    mesh=None,
    bm_method: str = "matmul",
    refine_warp: bool = False,
    affine_normalize_steps: bool = True,
    refine_sup_mode: str = "reference",
    refine_plateau_rtol: float = 0.0,
    seg_scale: int = 1,
    profile: str | None = None,
) -> tuple[BMFlowOutput, BMFlowState]:
    """The flagship driver (OpticalFlow_BlockMatching.cpp:13-362) —
    synchronous wrapper of :func:`optical_flow_block_matching_async`
    (dispatch + immediate fetch; see there for the parameter surface
    and the steady-state pipelining design)."""
    finalize, state = optical_flow_block_matching_async(
        it_rgb, itp1_rgb, max_int, param=param, mode=mode,
        iter_max=iter_max, state=state, search_range=search_range,
        kernel_spatial=kernel_spatial, kernel_intensity=kernel_intensity,
        subpixel_scale=subpixel_scale, mesh=mesh, bm_method=bm_method,
        refine_warp=refine_warp,
        affine_normalize_steps=affine_normalize_steps,
        refine_sup_mode=refine_sup_mode,
        refine_plateau_rtol=refine_plateau_rtol, seg_scale=seg_scale,
        profile=profile)
    return finalize(), state
