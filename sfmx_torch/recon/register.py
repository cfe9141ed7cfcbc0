"""Verified similarity registration (sim3): the primitive behind the
cross-session merge (``recon/merge``) and the in-session fusion of
secondary components (``recon/incremental``).  Port of
``sfmx.recon.register``.

A candidate similarity is accepted only if it passes all of:

  (a) support gate: inlier count and inlier fraction of the candidate
      correspondences;
  (b) split-half stability: two disjoint halves of the inlier set re-solve
      (closed-form Umeyama) to the same similarity within tolerance;
  (c) cross-reprojection (when scene context is given): each fused landmark
      pair, carried through the similarity, must reproject into the other
      session's observing cameras within pixels.

Attempts retry across descriptor-similarity thresholds and RANSAC draws;
exhausting them raises :class:`RegistrationError` with per-attempt
diagnostics.

As in the reference, the small Umeyama solves, the projections and the
landmark similarity run in host numpy; only the RANSAC of
``solve_sim3_gated`` runs on a device (``solvers/ransac`` over
``solvers/umeyama`` hypotheses), the device of its Gumbel noise.  The noise
is an input: ``solve_sim3_gated`` takes each attempt's (k_hypotheses, M)
draw, and the retry loops take a ``torch.Generator`` or a callable that
returns each attempt's draw given its shape, so that a test can feed the
reference's ``jax.random`` sequence draw by draw.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..solvers import ransac, umeyama


class RegistrationError(RuntimeError):
    """No candidate similarity passed verification; carries diagnostics."""

    def __init__(self, msg: str, attempts: list[dict] | None = None):
        self.attempts = attempts or []
        detail = "; ".join(
            "attempt(" + ", ".join(f"{k}={v}" for k, v in a.items()) + ")"
            for a in self.attempts[:6])
        super().__init__(f"{msg} [{detail}]" if detail else msg)


class RegResult(NamedTuple):
    s: float
    R: np.ndarray          # (3,3)
    t: np.ndarray          # (3,)
    pairs: np.ndarray      # (M,2) matched landmark ids (a_id, b_id)
    inliers: np.ndarray    # (M,) bool
    diag: dict


def noise_source(noise, device) -> Callable:
    """The per-attempt Gumbel draws of a retry loop: ``noise`` is a
    ``torch.Generator`` on ``device``, a callable ``shape -> tensor``, or
    None for a generator seeded 0 (the reference's default key is
    ``PRNGKey(0)``)."""
    device = torch.device(device)
    if callable(noise):
        return lambda shape: torch.as_tensor(noise(shape), dtype=torch.float32, device=device)
    gen = noise if noise is not None else torch.Generator(device=device).manual_seed(0)
    return lambda shape: ransac.gumbel_noise(shape, device=device, generator=gen)


# ---------------------------------------------------------------------------
# numpy Umeyama (host side: registration sets are small)
# ---------------------------------------------------------------------------

def _umeyama_np(src: np.ndarray, dst: np.ndarray):
    """Closed-form similarity s,R,t minimizing ||dst - (s R src + t)||^2."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    S = np.diag([1.0, 1.0, sgn])
    R = U @ S @ Vt
    var_s = (sc * sc).sum() / len(src)
    s = float((D * np.diag(S)).sum() / max(var_s, 1e-12))
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def _sim3_diff(m1, m2, extent: float, x_eval=None):
    """Difference between two similarities: (rot deg, scale ratio - 1,
    displacement gap as a fraction of scene extent), the displacement
    |m1(x) - m2(x)| taken at ``x_eval`` (the data centroid)."""
    s1, R1, t1 = m1
    s2, R2, t2 = m2
    dR = R1 @ R2.T
    cosang = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    rot_deg = float(np.degrees(np.arccos(cosang)))
    scale = float(abs(s1 / max(s2, 1e-12) - 1.0))
    x = np.zeros(3) if x_eval is None else np.asarray(x_eval, np.float64)
    disp = (s1 * (R1 @ x) + t1) - (s2 * (R2 @ x) + t2)
    trans = float(np.linalg.norm(disp) / max(extent, 1e-9))
    return rot_deg, scale, trans


# ---------------------------------------------------------------------------
# core: RANSAC + gates (a)+(b)
# ---------------------------------------------------------------------------

def _sim3_residual(model, pa, pb):
    s, R, t = model
    return torch.sum((umeyama.apply_sim3(s, R, t, pb) - pa) ** 2, dim=-1)


def ransac_sim3(gumbel: torch.Tensor, Pa: np.ndarray, Pb: np.ndarray, thresh: float):
    """3-point RANSAC of the similarity B -> A on ``gumbel``'s device: the
    best hypothesis' inliers (M,) bool numpy and their count."""
    dev = gumbel.device
    Pa_d = torch.as_tensor(np.asarray(Pa, np.float32), device=dev)
    Pb_d = torch.as_tensor(np.asarray(Pb, np.float32), device=dev)
    _, inl, cnt = ransac.ransac(
        gumbel, lambda pa, pb: umeyama.umeyama(pb, pa), _sim3_residual, (Pa_d, Pb_d),
        torch.ones(len(Pa), dtype=torch.bool, device=dev), sample_size=3,
        inlier_threshold=thresh)
    return inl.cpu().numpy(), int(cnt)


def solve_sim3_gated(
    gumbel: torch.Tensor,     # (k_hypotheses, M) sampling noise
    Pa: np.ndarray,           # (M,3) points in frame A
    Pb: np.ndarray,           # (M,3) corresponding points in frame B
    *,
    extent: float,            # scene-A spatial extent (gates scale with it)
    inlier_frac_of_extent: float = 0.02,
    min_inliers: int = 12,
    min_inlier_frac: float = 0.25,
    agree_rot_deg: float = 3.0,
    agree_scale: float = 0.05,
    agree_trans_frac: float = 0.03,
):
    """RANSAC sim3 B->A over correspondences + support/stability gates.

    The hypothesis count is ``gumbel``'s first dimension (the reference's
    ``k_hypotheses``).  Returns (model (s,R,t), inliers (M,), diag); model
    is None if any gate failed; diag always records what happened.
    """
    M = len(Pa)
    diag: dict = {"n_candidates": M}
    if M < 4:
        diag["fail"] = f"too few correspondences ({M} < 4)"
        return None, np.zeros(M, bool), diag

    thresh = (inlier_frac_of_extent * max(extent, 1e-9)) ** 2
    inl, n_inl = ransac_sim3(gumbel, Pa, Pb, thresh)
    diag["inliers"] = n_inl
    diag["inlier_frac"] = round(n_inl / M, 3)

    # (a) support gate
    if n_inl < min_inliers or n_inl < min_inlier_frac * M:
        diag["fail"] = (f"support gate: {n_inl} inliers "
                        f"({diag['inlier_frac']} of {M}; need >= "
                        f"{min_inliers} and >= {min_inlier_frac})")
        return None, inl, diag

    # refine on all inliers (numpy: the final model)
    ia = np.flatnonzero(inl)
    s_f, R_f, t_f = _umeyama_np(Pb[ia], Pa[ia])

    # (b) split-half stability: interleaved halves (spatially mixed)
    h1, h2 = ia[0::2], ia[1::2]
    if len(h1) >= 3 and len(h2) >= 3:
        m1 = _umeyama_np(Pb[h1], Pa[h1])
        m2 = _umeyama_np(Pb[h2], Pa[h2])
        rot_deg, scale, trans = _sim3_diff(m1, m2, extent, x_eval=Pb[ia].mean(0))
        diag["split_rot_deg"] = round(rot_deg, 3)
        diag["split_scale"] = round(scale, 4)
        diag["split_trans_frac"] = round(trans, 4)
        if rot_deg > agree_rot_deg or scale > agree_scale or trans > agree_trans_frac:
            diag["fail"] = ("split-half instability: halves disagree by "
                            f"{rot_deg:.2f} deg / {scale:.3f} scale / "
                            f"{trans:.3f} extent-frac")
            return None, inl, diag

    return (s_f, R_f, t_f), inl, diag


# ---------------------------------------------------------------------------
# gate (c): cross-reprojection against the other session's measurements
# ---------------------------------------------------------------------------

def _obs_slices(obs_pt: np.ndarray, obs_alive: np.ndarray, n_pts: int):
    """Sorted-by-landmark view of the alive observation table."""
    idx = np.flatnonzero(obs_alive)
    order = idx[np.argsort(obs_pt[idx], kind="stable")]
    pts = obs_pt[order]
    starts = np.searchsorted(pts, np.arange(n_pts))
    ends = np.searchsorted(pts, np.arange(n_pts), side="right")
    return order, starts, ends


def _project_np(intr: np.ndarray, cam_k: np.ndarray, cam_R: np.ndarray,
                cam_t: np.ndarray, cams: np.ndarray, X: np.ndarray):
    """Pixel projection of X[i] into camera cams[i] (vectorized numpy)."""
    k = intr[cam_k[cams]]                                  # (N,7)
    Xc = np.einsum("nij,nj->ni", cam_R[cams], X) + cam_t[cams]
    z = Xc[:, 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    xn = Xc[:, :2] / zs[:, None]
    r2 = (xn * xn).sum(-1)
    radial = 1.0 + k[:, 4] * r2 + k[:, 5] * r2 * r2 + k[:, 6] * r2 ** 3
    xd = xn * radial[:, None]
    uv = xd * k[:, 0:2] + k[:, 2:4]
    return uv, z


def cross_reprojection_px(model, pairs: np.ndarray, sc_a: dict, sc_b: dict,
                          *, max_obs_per_lm: int = 4):
    """Median pixel error of fused pairs projected into the OTHER session.

    ``model`` is (s,R,t) taking B coords into A's frame.  For each pair
    (a_id, b_id): sim3(Xb[b_id]) is projected into A's cameras observing
    a_id (vs their measured uv), and sim3^-1(Xa[a_id]) into B's cameras
    observing b_id.  Scene dicts (numpy) need keys X, intr, cam_k, R, t,
    obs_cam, obs_pt, obs_uv, obs_alive.
    """
    s, R, t = model
    errs = []
    for (sc_src, sc_dst, col, fwd) in ((sc_b, sc_a, 0, True),
                                       (sc_a, sc_b, 1, False)):
        # carry src landmark into dst frame
        Xsrc = sc_src["X"][pairs[:, 1 - col]]
        if fwd:
            Y = s * (Xsrc @ R.T) + t
        else:
            Y = ((Xsrc - t) / max(s, 1e-12)) @ R
        order, starts, ends = _obs_slices(
            sc_dst["obs_pt"], sc_dst["obs_alive"], len(sc_dst["X"]))
        lm = pairs[:, col]
        n = np.minimum(ends[lm] - starts[lm], max_obs_per_lm)
        slot = np.arange(max_obs_per_lm)[None, :]
        oidx = order[np.minimum(starts[lm][:, None] + slot,
                                len(order) - 1 if len(order) else 0)]
        valid = slot < n[:, None]
        if not valid.any():
            continue
        cams = sc_dst["obs_cam"][oidx][valid]
        uv_obs = sc_dst["obs_uv"][oidx][valid]
        Yrep = np.repeat(Y[:, None, :], max_obs_per_lm, axis=1)[valid]
        uv_pred, z = _project_np(sc_dst["intr"], sc_dst["cam_k"],
                                 sc_dst["R"], sc_dst["t"], cams, Yrep)
        e = np.linalg.norm(uv_pred - uv_obs, axis=-1)
        e = np.where(z > 1e-6, e, 1e6)  # behind-camera = hard failure
        errs.append(e)
    if not errs:
        return float("inf")
    return float(np.median(np.concatenate(errs)))


# ---------------------------------------------------------------------------
# candidate generation: descriptor-matched landmark pairs
# ---------------------------------------------------------------------------

def match_landmark_pairs(desc_a, alive_a, desc_b, alive_b, sim_thresh: float = 0.7):
    """Mutual-best cosine matches between per-landmark mean descriptors
    (a host (P_a x P_b) product, as in the reference)."""
    sim = desc_a @ desc_b.T
    sim[~alive_a] = -2
    sim[:, ~alive_b] = -2
    best_b = sim.argmax(1)
    best_s = sim.max(1)
    mutual = sim.argmax(0)[best_b] == np.arange(len(desc_a))
    cand = (best_s > sim_thresh) & mutual & alive_a
    ia = np.flatnonzero(cand)
    return ia, best_b[ia], best_s[ia]


# ---------------------------------------------------------------------------
# the public verified primitives
# ---------------------------------------------------------------------------

def register_landmarks_verified(
    Xa, desc_a, alive_a, Xb, desc_b, alive_b, *,
    device,
    scene_a: dict | None = None, scene_b: dict | None = None,
    noise=None,
    sim_schedule=(0.7, 0.6),
    n_keys: int = 2,
    k_hypotheses: int = 2048,
    min_inliers: int = 12,
    min_inlier_frac: float = 0.25,
    reproj_px: float = 10.0,
    inlier_frac_of_extent: float = 0.02,
) -> RegResult:
    """Descriptor-based cross-session registration, verified (B -> A frame).

    Retries across descriptor-similarity thresholds and ``n_keys`` RANSAC
    draws each (``noise``, see ``noise_source``; the RANSAC runs on
    ``device``); every attempt must pass the support, stability and (when
    scenes are given) cross-reprojection gates.  Returns the best verified
    attempt by (inlier count, then reprojection error).  Raises
    RegistrationError with per-attempt diagnostics when nothing verifies.
    """
    draw = noise_source(noise, device)
    extent = float(np.linalg.norm(Xa[alive_a].max(0) - Xa[alive_a].min(0))) \
        if alive_a.any() else 0.0
    attempts: list[dict] = []
    verified: list[tuple] = []
    for sim_thresh in sim_schedule:
        ia, ib, _ = match_landmark_pairs(desc_a, alive_a, desc_b, alive_b, sim_thresh)
        if len(ia) < 4:
            attempts.append({"sim_thresh": sim_thresh, "n_candidates": len(ia),
                             "fail": "too few descriptor matches"})
            continue
        pairs = np.stack([ia, ib], axis=1)
        for ki in range(n_keys):
            model, inl, diag = solve_sim3_gated(
                draw((k_hypotheses, len(ia))), Xa[ia], Xb[ib], extent=extent,
                inlier_frac_of_extent=inlier_frac_of_extent,
                min_inliers=min_inliers, min_inlier_frac=min_inlier_frac)
            diag["sim_thresh"] = sim_thresh
            diag["key"] = ki
            if model is None:
                attempts.append(diag)
                continue
            if scene_a is not None and scene_b is not None:
                med_px = cross_reprojection_px(model, pairs[inl], scene_a, scene_b)
                diag["reproj_px"] = round(med_px, 2)
                if not (med_px < reproj_px):
                    diag["fail"] = (f"cross-reprojection gate: median "
                                    f"{med_px:.1f} px (need < {reproj_px})")
                    attempts.append(diag)
                    continue
            diag["verified"] = True
            attempts.append(diag)
            verified.append((int(inl.sum()), -diag.get("reproj_px", 0.0),
                             model, pairs, inl, diag))
    if not verified:
        raise RegistrationError("cross-session registration failed verification", attempts)
    verified.sort(key=lambda v: (v[0], v[1]), reverse=True)
    _, _, (s, R, t), pairs, inl, diag = verified[0]
    diag["n_attempts"] = len(attempts)
    return RegResult(float(s), np.asarray(R), np.asarray(t), pairs, np.asarray(inl), diag)


def register_rigid_anchored(
    Ra, Rb, Pa, Pb, *, extent: float | None = None,
    rot_inlier_deg: float = 10.0, min_rot_inliers: int = 3,
    min_point_inliers: int = 8, inlier_frac_of_extent: float = 0.02,
    agree_scale: float | None = 0.05, agree_trans_frac: float | None = 0.03,
) -> RegResult:
    """Sim3 B->A anchored on shared CAMERA ORIENTATIONS (in-session
    component fusion), host numpy.

    Every shared camera satisfies R = R_a[c]^T R_b[c] exactly, so the
    rotation is the robust average of the per-camera candidates (mode +
    reject > rot_inlier_deg); (s, T) then come from 2-point RANSAC over the
    point/center pairs (a fixed numpy draw, as in the reference) refit on
    the inliers, with an optional split-half check on (s, T) alone.

    Args: Ra/Rb (S,3,3) world-to-cam of the SAME cameras in frames A/B;
    Pa/Pb (M,3) corresponding points (shared landmarks and/or camera
    centers).  Raises RegistrationError when the anchor or the fit fails.
    """
    Ra = np.asarray(Ra, np.float64)
    Rb = np.asarray(Rb, np.float64)
    Pa = np.asarray(Pa, np.float64)
    Pb = np.asarray(Pb, np.float64)
    S = len(Ra)
    diag: dict = {"n_shared_cams": S, "n_points": len(Pa)}
    if S < min_rot_inliers:
        raise RegistrationError(
            f"rotation anchor needs >= {min_rot_inliers} shared cameras, got {S}", [diag])
    cand = np.einsum("cji,cjk->cik", Ra, Rb)      # (S,3,3) R_a^T R_b
    # pairwise geodesic distances -> mode candidate
    tr = np.einsum("cij,dij->cd", cand, cand)     # trace(Rc Rd^T)
    ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    med = np.median(ang, axis=1)
    mode = int(np.argmin(med))
    rot_inl = ang[mode] <= rot_inlier_deg
    diag["rot_inliers"] = int(rot_inl.sum())
    diag["rot_spread_deg"] = round(float(np.median(ang[mode][rot_inl])), 3)
    if int(rot_inl.sum()) < min_rot_inliers:
        diag["fail"] = (f"rotation anchor: only {int(rot_inl.sum())} of {S} "
                        f"cameras agree within {rot_inlier_deg} deg")
        raise RegistrationError("anchored registration failed", [diag])
    M = cand[rot_inl].sum(0)
    U, _, Vt = np.linalg.svd(M)
    sgn = np.sign(np.linalg.det(U @ Vt))
    R = U @ np.diag([1.0, 1.0, sgn]) @ Vt         # B->A rotation

    # robust (s, T) given R: 2-point minimal samples give s from the pair's
    # distance ratio and T from the pair midpoint; RANSAC those, refit on
    # the inliers
    if len(Pa) < 3:
        diag["fail"] = f"too few point correspondences ({len(Pa)})"
        raise RegistrationError("anchored registration failed", [diag])
    Qb = Pb @ R.T
    if extent is None:
        extent = float(np.linalg.norm(Pa.max(0) - Pa.min(0)))
    thresh = inlier_frac_of_extent * max(extent, 1e-9)
    rng_st = np.random.default_rng(0)
    M = len(Pa)
    n_hyp = min(256, M * (M - 1))
    ii = rng_st.integers(0, M, n_hyp)
    jj = rng_st.integers(0, M - 1, n_hyp)
    jj = np.where(jj >= ii, jj + 1, jj)
    da = np.linalg.norm(Pa[ii] - Pa[jj], axis=1)
    dq = np.linalg.norm(Qb[ii] - Qb[jj], axis=1)
    s_h = da / np.maximum(dq, 1e-12)                       # (H,)
    T_h = 0.5 * (Pa[ii] + Pa[jj]) - s_h[:, None] * 0.5 * (Qb[ii] + Qb[jj])
    resid_h = np.linalg.norm(
        Pa[None, :, :] - (s_h[:, None, None] * Qb[None, :, :]
                          + T_h[:, None, :]), axis=2)      # (H,M)
    cnt_h = (resid_h < thresh).sum(1)
    best = int(np.argmax(cnt_h))
    inl = resid_h[best] < thresh
    diag["inliers"] = int(inl.sum())
    diag["inlier_frac"] = round(float(inl.mean()), 3)
    s = float(s_h[best])
    T = T_h[best]
    if int(inl.sum()) < min_point_inliers or inl.mean() < 0.25:
        diag["fail"] = (f"support gate: {int(inl.sum())} point inliers "
                        f"({inl.mean():.2f})")
        raise RegistrationError("anchored registration failed", [diag])

    # refit (s,T) on inliers + split-half stability of (s,T) ONLY (R fixed)
    def fit_st(idx):
        qa_ = ((Pa[idx] - Pa[idx].mean(0)) * (Qb[idx] - Qb[idx].mean(0))).sum()
        qq_ = ((Qb[idx] - Qb[idx].mean(0)) ** 2).sum()
        s_ = qa_ / max(qq_, 1e-12)
        return s_, Pa[idx].mean(0) - s_ * Qb[idx].mean(0)

    ii = np.flatnonzero(inl)
    s, T = fit_st(ii)
    h1, h2 = ii[0::2], ii[1::2]
    # agree_* None disables the split-half gate: in-session fusion has a
    # stronger downstream verifier (the post-fusion BA reprojection check)
    if (agree_scale is not None and agree_trans_frac is not None
            and len(h1) >= 3 and len(h2) >= 3):
        s1_, T1 = fit_st(h1)
        s2_, T2 = fit_st(h2)
        dscale = abs(s1_ / max(s2_, 1e-12) - 1.0)
        # displacement at the data centroid, not the origin
        q_mu = Qb[ii].mean(0)
        dtrans = float(np.linalg.norm((s1_ * q_mu + T1) - (s2_ * q_mu + T2))
                       / max(extent, 1e-9))
        diag["split_scale"] = round(float(dscale), 4)
        diag["split_trans_frac"] = round(dtrans, 4)
        if dscale > agree_scale or dtrans > agree_trans_frac:
            diag["fail"] = ("split-half instability (s,T): "
                            f"{dscale:.3f} scale / {dtrans:.3f} extent-frac")
            raise RegistrationError("anchored registration failed", [diag])
    diag["verified"] = True
    pairs = np.stack([np.arange(len(Pa))] * 2, axis=1)
    return RegResult(float(s), R.astype(np.float64), np.asarray(T), pairs, inl, diag)


def register_points_verified(
    Pa, Pb, *, device, noise=None, extent: float | None = None,
    k_hypotheses: int = 2048, min_inliers: int = 12,
    min_inlier_frac: float = 0.25, n_keys: int = 2,
    inlier_frac_of_extent: float = 0.02,
) -> RegResult:
    """Direct-correspondence registration (B -> A), verified.

    For callers that already know the correspondence (the in-session
    components, whose shared track ids are exact): no descriptor matching,
    gated RANSAC + stability on ``device``, retried over ``n_keys`` draws
    of ``noise`` (see ``noise_source``).  Raises RegistrationError when
    nothing verifies.
    """
    draw = noise_source(noise, device)
    Pa = np.asarray(Pa, np.float32)
    Pb = np.asarray(Pb, np.float32)
    if extent is None:
        extent = float(np.linalg.norm(Pa.max(0) - Pa.min(0))) if len(Pa) else 0.0
    attempts = []
    for ki in range(n_keys):
        model, inl, diag = solve_sim3_gated(
            draw((k_hypotheses, len(Pa))), Pa, Pb, extent=extent,
            inlier_frac_of_extent=inlier_frac_of_extent,
            min_inliers=min_inliers, min_inlier_frac=min_inlier_frac)
        diag["key"] = ki
        attempts.append(diag)
        if model is not None:
            diag["verified"] = True
            s, R, t = model
            pairs = np.stack([np.arange(len(Pa))] * 2, axis=1)
            return RegResult(float(s), R, t, pairs, inl, diag)
    raise RegistrationError(
        "point-correspondence registration failed verification", attempts)
