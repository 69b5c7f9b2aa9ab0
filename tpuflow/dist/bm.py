"""Distributed block matching: search-space (candidate) parallelism.

The reference's flagship block-matching search
(``OpticalFlow_BlockMatching.cpp:198-219`` ->
``BlockMatching<Lab>::block_matching(61, 1.0, 0.5)``) parallelizes with
OpenMP inside the per-region loops (SURVEY.md §2.6). Regions are
irregular, so the matcher (tpuflow/blockmatching/matcher.py)
evaluates the (2R+1)^2 candidate displacement grid densely; the natural
multi-device decomposition is therefore the *candidate axis*: every device
scores an equal slice of the search grid against the full (replicated,
KITTI-sized) frames, the tiny (n_cand, n_regions) partial cost tables
all-gather over the mesh, and the argmin + subpixel refinement replay
replicated — bitwise the single-device result, with the O(n_pix x
n_cand) search cost split D ways and only O(n_cand x n_regions) floats
on the interconnect.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from tpuflow.blockmatching.matcher import (
    BlockMatchResult,
    _coarse_argmin_and_refine,
    _coarse_padded_candidates,
    _half_res,
    _integer_costs,
    _integer_costs_matmul,
    _integer_costs_matmul_bidi,
    _argmin_and_refine,
    _padded_candidates,
    pad_region_bounds,
    region_bucket,
    region_reduction_plan,
    validate_method,
)
from tpuflow.dist.solvers import shard_map


def _is_coarse(method: str) -> bool:
    """Methods that sweep the stride-2/3 candidate subgrid and finish
    with the full-res local refinement tail."""
    return (method.startswith("matmul_coarse")
            or method.startswith("matmul_half"))


def _coarse_stride(method: str) -> int:
    return 3 if method.endswith("3") else 2


def _refine_radius(method: str) -> int:
    return 2 if method == "matmul_half2" else 1


def _half_radius(search_range: int) -> int:
    """Max |displacement| of the half-res candidate grid (the reference
    pad margin of the subsampled evaluator)."""
    return -(-(search_range // 2) // 2)


def _dot_dtype(method: str):
    return jnp.bfloat16 if method == "matmul_bf16" else None


def _local_costs(cur_t, ref_t, labels_t, n_regions, cand_t, coeff_mad,
                 coeff_zncc, chunk, search_range, method):
    """One device's slice of the integer cost table, dispatched on
    ``method`` — the single copy of the single-direction evaluator
    dispatch (the bidi twin is :func:`_local_costs_bidi`; both share
    :func:`_half_radius`/:func:`_dot_dtype`)."""
    if method.startswith("matmul_half"):
        return _integer_costs_matmul(
            _half_res(cur_t), _half_res(ref_t), labels_t[::2, ::2],
            n_regions, cand_t // 2, coeff_mad, coeff_zncc, chunk,
            _half_radius(search_range), None)
    return _integer_costs_matmul(
        cur_t, ref_t, labels_t, n_regions, cand_t, coeff_mad,
        coeff_zncc, chunk, search_range // 2, _dot_dtype(method))


def _local_costs_bidi(cur_t, refp_t, refn_t, labels_t, n_regions,
                      cand_t, coeff_mad, coeff_zncc, chunk,
                      search_range, method):
    """Fused-bidirectional twin of :func:`_local_costs`."""
    if method.startswith("matmul_half"):
        return _integer_costs_matmul_bidi(
            _half_res(cur_t), _half_res(refp_t), _half_res(refn_t),
            labels_t[::2, ::2], n_regions, cand_t // 2, coeff_mad,
            coeff_zncc, chunk, _half_radius(search_range), None)
    return _integer_costs_matmul_bidi(
        cur_t, refp_t, refn_t, labels_t, n_regions, cand_t, coeff_mad,
        coeff_zncc, chunk, search_range // 2, _dot_dtype(method))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_regions", "search_range", "subpixel_scale",
                     "coeff_mad", "coeff_zncc", "chunk", "method"))
def _match_sharded(cur_lab, ref_lab, labels, perm, bounds, cand,
                   mesh: Mesh, n_regions: int, search_range: int,
                   subpixel_scale: int, coeff_mad: float,
                   coeff_zncc: float, chunk: int, method: str = "matmul"):
    rep = P(None)

    def body(cur_t, ref_t, labels_t, perm_t, bounds_t, cand_t):
        if method.startswith("matmul"):
            local = _local_costs(cur_t, ref_t, labels_t, n_regions,
                                 cand_t, coeff_mad, coeff_zncc, chunk,
                                 search_range, method)
        else:
            local = _integer_costs(cur_t, ref_t, perm_t, bounds_t,
                                   n_regions, cand_t, coeff_mad,
                                   coeff_zncc, chunk)
        # (D, n_local, n_regions) in device (= global candidate) order.
        costs = lax.all_gather(local, ("ty", "tx"))
        return costs.reshape(-1, n_regions)[None]

    f = shard_map(
        body, mesh,
        in_specs=(rep, rep, rep, rep, rep, P(("ty", "tx"), None)),
        out_specs=P(("ty", "tx"), None, None))
    costs = f(cur_lab, ref_lab, labels, perm, bounds, cand)[0]
    if _is_coarse(method):
        return _coarse_argmin_and_refine(
            costs, cur_lab, ref_lab, labels, perm, bounds, n_regions,
            search_range, subpixel_scale, coeff_mad, coeff_zncc,
            _coarse_stride(method), _refine_radius(method))
    return _argmin_and_refine(costs, cur_lab, ref_lab, labels, perm,
                              bounds, n_regions, search_range,
                              subpixel_scale, coeff_mad, coeff_zncc)


def _match_device_sharded(cur_lab, ref_lab, labels, n_regions: int,
                          mesh: Mesh, search_range, coeff_mad, coeff_zncc,
                          subpixel_scale, chunk, method: str = "matmul"):
    """Dispatch one direction's candidate-parallel search over the mesh;
    returns device arrays (uv, cost) padded to the bucketed region count
    — no host sync (the distributed twin of matcher._match_device)."""
    validate_method(method)
    if method.startswith("matmul"):
        chunk = max(chunk, 64)
    # Pad so every device holds a chunk-multiple slice ((0, 0) fillers,
    # discarded after the all-gather — global order is preserved), and
    # bucket the region count like the single-device matcher (stable
    # jit signature across frames).
    n_shards = int(np.prod(mesh.devices.shape))
    if _is_coarse(method):
        cand, _ = _coarse_padded_candidates(
            search_range, chunk, _coarse_stride(method), n_shards)
    else:
        cand = _padded_candidates(search_range, chunk, n_shards)
    perm, bounds = region_reduction_plan(np.asarray(labels),
                                         int(n_regions))
    n_pad_r = region_bucket(int(n_regions))
    bounds = pad_region_bounds(bounds, n_pad_r)
    return _match_sharded(
        jnp.asarray(cur_lab), jnp.asarray(ref_lab), jnp.asarray(labels),
        jnp.asarray(perm), jnp.asarray(bounds), cand, mesh, n_pad_r,
        int(search_range), int(subpixel_scale), float(coeff_mad),
        float(coeff_zncc), int(chunk), method)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_regions", "search_range", "subpixel_scale",
                     "coeff_mad", "coeff_zncc", "chunk", "method"))
def _match_sharded_bidi(cur_lab, refp_lab, refn_lab, labels, perm, bounds,
                        cand, mesh: Mesh, n_regions: int,
                        search_range: int, subpixel_scale: int,
                        coeff_mad: float, coeff_zncc: float, chunk: int,
                        method: str = "matmul"):
    """Candidate-parallel FUSED bidirectional search: each device scores
    its slice of the displacement grid against BOTH reference frames
    through the shared-field evaluator
    (matcher._integer_costs_matmul_bidi), the two cost tables
    all-gather, and each direction's argmin + subpixel refinement
    replays replicated — bitwise the fused single-device program."""
    rep = P(None)

    def body(cur_t, refp_t, refn_t, labels_t, perm_t, bounds_t, cand_t):
        local_p, local_n = _local_costs_bidi(
            cur_t, refp_t, refn_t, labels_t, n_regions, cand_t,
            coeff_mad, coeff_zncc, chunk, search_range, method)
        # (D, n_local, n_regions) in device (= global candidate) order.
        cp = lax.all_gather(local_p, ("ty", "tx")).reshape(-1, n_regions)
        cn = lax.all_gather(local_n, ("ty", "tx")).reshape(-1, n_regions)
        return cp[None], cn[None]

    f = shard_map(
        body, mesh,
        in_specs=(rep, rep, rep, rep, rep, rep, P(("ty", "tx"), None)),
        out_specs=(P(("ty", "tx"), None, None),) * 2)
    costs_pair = f(cur_lab, refp_lab, refn_lab, labels, perm, bounds, cand)
    if _is_coarse(method):
        return tuple(
            _coarse_argmin_and_refine(
                costs[0], cur_lab, ref_lab, labels, perm, bounds,
                n_regions, search_range, subpixel_scale, coeff_mad,
                coeff_zncc, _coarse_stride(method),
                _refine_radius(method))
            for costs, ref_lab in zip(costs_pair, (refp_lab, refn_lab)))
    return tuple(
        _argmin_and_refine(costs[0], cur_lab, ref_lab, labels, perm,
                           bounds, n_regions, search_range,
                           subpixel_scale, coeff_mad, coeff_zncc)
        for costs, ref_lab in zip(costs_pair, (refp_lab, refn_lab)))


def _match_device_sharded_bidirectional(cur_lab, refp_lab, refn_lab,
                                        labels, n_regions: int,
                                        mesh: Mesh, search_range,
                                        coeff_mad, coeff_zncc,
                                        subpixel_scale, chunk,
                                        method: str = "matmul"):
    """Dispatch BOTH directions' candidate-parallel searches as one
    program over the mesh (matmul methods; the gather evaluator falls
    back to two :func:`_match_device_sharded` programs). Returns
    ((uv_p, cost_p), (uv_n, cost_n)) padded to the bucketed region
    count — no host sync."""
    validate_method(method)
    if not method.startswith("matmul"):
        return (_match_device_sharded(cur_lab, refp_lab, labels,
                                      n_regions, mesh, search_range,
                                      coeff_mad, coeff_zncc,
                                      subpixel_scale, chunk, method),
                _match_device_sharded(cur_lab, refn_lab, labels,
                                      n_regions, mesh, search_range,
                                      coeff_mad, coeff_zncc,
                                      subpixel_scale, chunk, method))
    chunk = max(chunk, 64)
    n_shards = int(np.prod(mesh.devices.shape))
    if _is_coarse(method):
        cand, _ = _coarse_padded_candidates(
            search_range, chunk, _coarse_stride(method), n_shards)
    else:
        cand = _padded_candidates(search_range, chunk, n_shards)
    perm, bounds = region_reduction_plan(np.asarray(labels),
                                         int(n_regions))
    n_pad_r = region_bucket(int(n_regions))
    bounds = pad_region_bounds(bounds, n_pad_r)
    return _match_sharded_bidi(
        jnp.asarray(cur_lab), jnp.asarray(refp_lab),
        jnp.asarray(refn_lab), jnp.asarray(labels),
        jnp.asarray(perm), jnp.asarray(bounds), cand, mesh, n_pad_r,
        int(search_range), int(subpixel_scale), float(coeff_mad),
        float(coeff_zncc), int(chunk), method)


def block_matching_labels_sharded(
    cur_lab,
    ref_lab,
    labels,
    n_regions: int,
    mesh: Mesh,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
) -> BlockMatchResult:
    """Distributed block_matching_labels: same result, search split over
    the mesh's devices along the candidate axis."""
    uv, cost = _match_device_sharded(
        cur_lab, ref_lab, labels, n_regions, mesh, search_range,
        coeff_mad, coeff_zncc, subpixel_scale, chunk, method)
    uv = np.asarray(uv)[:n_regions]
    cost = np.asarray(cost)[:n_regions]
    lab_np = np.asarray(labels)
    return BlockMatchResult(
        u=uv[lab_np][..., 0], v=uv[lab_np][..., 1], cost=cost[lab_np],
        region_uv=uv, region_cost=cost)
