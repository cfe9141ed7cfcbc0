"""Incremental SfM engine: two-view init, resection, triangulation, BA,
secondary components fused through a verified similarity, the checkpointed
final BA and the joint intrinsics BA (port of ``sfmx.recon.incremental``).

As in the reference: landmark id == track id, the observation table is
fixed at track-build time and "growing the map" flips alive masks; every
round re-triangulates ALL unreconstructed tracks against the registered set
in one batched N-view DLT call, resects all eligible cameras in one batched
PnP-RANSAC call and runs a bundle adjustment; which camera comes next is
host orchestration over numpy state.

Not carried over from the reference, because they answer XLA recompiles or
the TPU compiler and have no meaning for eager PyTorch: the power-of-two
buckets of the BA table, the candidate batch and the resection batch, the
per-bucket memo of dense-BA settings, and the rerun of a BA call on the
planes path when the fused path fails to compile (here a kernel that does
not build or launch raises, and fails the build).  BA sees exactly the
alive observations, the joint intrinsics BA included.
"""
from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from ..core import cameras
from ..mapstore.scene import Scene, new_scene
from ..solvers import ba_ckpt, epipolar, lm, p3p, pnp, ransac, triangulate
from .register import RegistrationError, register_points_verified, register_rigid_anchored
from .tracks import TrackTable


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    max_track_views: int = 8          # V cap for n-view triangulation
    ransac_hypotheses: int = 512
    resection_solver: str = "dlt6"    # dlt6 | p3p (3-pt, 4 candidates)
    px_thresh: float = 4.0            # inlier threshold (pixels)
    min_parallax_deg: float = 1.5
    min_init_inliers: int = 30
    min_resection_inliers: int = 10
    ba_every: int = 3
    ba_iters: int = 10
    final_ba_iters: int = 25
    cg_iters: int = 30
    huber_px: float = 4.0
    min_track_views: int = 2
    batch_resection: bool = True   # resect ALL eligible cams per round (scalable)
    # Multi-component reconstruction: when coverage stalls below
    # coverage_target, seed a secondary component among the unregistered
    # cameras (plus a bridge of covisible registered ones) and fuse it
    # through a verified similarity (recon/register.py)
    max_components: int = 3
    coverage_target: float = 0.96
    bridge_cams: int = 48
    refine_intrinsics: tuple | None = None  # e.g. ("f","k1"): joint final BA
    final_ba_ckpt: str | None = None        # checkpointed final BA (npz path)
    final_ba_ckpt_every: int = 10
    # fused dense-layout BA (kernels/segsum.py): "auto" = on a CUDA device
    # once the obs table is big enough to amortize the layout build
    dense_ba: str = "auto"            # auto | on | off
    dense_ba_min_obs: int = 20000
    seed: int = 0


class ReconError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Device steps (the batch axis written out)
# ---------------------------------------------------------------------------


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x (B,N) over mask per row, the mean of the two middle
    values for an even count (numpy's rule); NaN for an empty row."""
    v = torch.sort(torch.where(mask, x, torch.full_like(x, torch.inf)), dim=-1).values
    n = mask.sum(dim=-1)
    lo = torch.clamp((n - 1) // 2, min=0)[:, None]
    hi = torch.clamp(n // 2, max=x.shape[-1] - 1)[:, None]
    med = 0.5 * (torch.gather(v, 1, lo) + torch.gather(v, 1, hi))[:, 0]
    return torch.where(n > 0, med, torch.full_like(med, torch.nan))


def _init_pair_batch(gumbel, xn_a, xn_b, valid, thresh: float):
    """E-RANSAC + relative pose for all init-pair candidates at once.

    gumbel (B,H,K) sampling noise, xn_a/xn_b (B,K,2), valid (B,K).  Returns
    (R (B,3,3), t (B,3), inliers (B,K), count (B,), median triangulation
    angle of the inliers in degrees (B,))."""

    def solver(x1s, x2s):
        ones = torch.ones(x1s.shape[:-1], dtype=torch.bool, device=x1s.device)
        return (epipolar.eight_point(x1s, x2s, ones, essential=True),)

    def residual_fn(model, x1d, x2d):
        return epipolar.sampson_error_batch(model[0], x1d, x2d)

    (E,), inliers, cnt = ransac.ransac(gumbel, solver, residual_fn, (xn_a, xn_b), valid,
                                       sample_size=8, inlier_threshold=thresh)
    Rs, ts, Xs = [], [], []
    for b in range(E.shape[0]):
        R, t, _n_front, X = epipolar.relative_pose_from_essential(E[b], xn_a[b], xn_b[b],
                                                                  inliers[b])
        Rs.append(R)
        ts.append(t)
        Xs.append(X)
    R, t, X = torch.stack(Rs), torch.stack(ts), torch.stack(Xs)
    c2 = -(R.transpose(1, 2) @ t[:, :, None])[:, :, 0]
    par = triangulate.parallax_deg(torch.zeros_like(c2)[:, None, :], c2[:, None, :], X)
    return R, t, inliers, cnt, _masked_median(par, inliers)


def _init_pair_step(gumbel, xn_a, xn_b, valid, thresh: float):
    """One candidate pair: gumbel (H,K), xn_a/xn_b (K,2), valid (K,)."""
    return tuple(x[0] for x in _init_pair_batch(gumbel[None], xn_a[None], xn_b[None],
                                                valid[None], thresh))


def _resect_batch(gumbel, xn_b, X_b, valid_b, thresh_n: float, solver: str = "dlt6"):
    """PnP-RANSAC + Gauss-Newton refine of all eligible cameras at once.

    gumbel (B,H,K), xn_b (B,K,2), X_b (B,K,3), valid_b (B,K).  Returns
    (R (B,3,3), t (B,3), inliers (B,K), count (B,))."""

    def residual_fn(model, xn_d, X_d):
        R, t = model
        r = pnp.pnp_residual(R, t, xn_d, X_d)
        return torch.sum(r * r, dim=-1)

    if solver == "p3p":
        min_solver, n_samp, n_cand = p3p.p3p_minimal, p3p.MIN_SAMPLE, p3p.N_CANDIDATES
    else:
        min_solver, n_samp, n_cand = pnp.dlt_pnp_minimal, pnp.MIN_SAMPLE, 1
    (R, t), inliers, _ = ransac.ransac(gumbel, min_solver, residual_fn, (xn_b, X_b), valid_b,
                                       sample_size=n_samp, inlier_threshold=thresh_n,
                                       n_candidates=n_cand)
    R, t = pnp.refine_pnp_gn(R, t, xn_b, X_b, inliers)
    inliers = (residual_fn((R, t), xn_b, X_b) < thresh_n) & valid_b
    return R, t, inliers, torch.sum(inliers, dim=-1, dtype=torch.int32)


def _resect_step_impl(gumbel, xn, X, valid, thresh_n: float, solver: str = "dlt6"):
    """One camera against its 2D-3D set: gumbel (H,K), xn (K,2), X (K,3)."""
    return tuple(x[0] for x in _resect_batch(gumbel[None], xn[None], X[None], valid[None],
                                             thresh_n, solver))


def _triangulate_all(cam_R, cam_t, registered, xn_feat, tr_obs_cam, tr_obs_xn_idx, tr_obs_mask,
                     thresh_n: float, min_parallax_deg: float):
    """Re-triangulate every track from its registered observations.

    xn_feat (C,K,2) normalized coords of all features; tr_obs_cam /
    tr_obs_xn_idx / tr_obs_mask (T,V) camera id, feature index and validity
    of each track observation slot.  Returns (X (T,3), ok (T,)) gated on
    cheirality in all registered views, reprojection below thresh_n in all
    of them, and the largest pairwise parallax."""
    cam = tr_obs_cam.long()
    use = tr_obs_mask & registered[cam]                                   # (T,V)
    Ps = torch.cat([cam_R, cam_t[:, :, None]], dim=2)[cam]                # (T,V,3,4)
    xns = xn_feat[cam, tr_obs_xn_idx.long()]                              # (T,V,2)
    X, ok2 = triangulate.triangulate_nview_b(Ps, xns, use)
    Xc = (Ps[..., :3] @ X[:, None, :, None])[..., 0] + Ps[..., 3]         # (T,V,3)
    z = Xc[..., 2]
    cheir = torch.where(use, z > 1e-3, True).all(dim=1)
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    reproj = Xc[..., :2] / zs[..., None] - xns
    err = torch.sum(reproj * reproj, dim=-1)
    reproj_ok = torch.where(use, err < thresh_n, True).all(dim=1)
    centers = -(cam_R.transpose(1, 2) @ cam_t[:, :, None])[:, :, 0][cam]  # (T,V,3)
    d = centers - X[:, None, :]
    dn = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
    cosang = dn @ dn.transpose(1, 2)                                      # (T,V,V)
    pair_ok = use[:, :, None] & use[:, None, :]
    min_cos = torch.where(pair_ok, cosang, torch.ones_like(cosang)).flatten(1).amin(dim=1)
    par_ok = min_cos < float(np.cos(np.deg2rad(min_parallax_deg)))
    return X, ok2 & cheir & reproj_ok & par_ok


def _reproj_err2_norm(cam_R, cam_t, X, obs_cam, obs_pt, xn_obs):
    """Squared reprojection error in normalized coords for every observation."""
    ci = obs_cam.long()
    Xc = (cam_R[ci] @ X[obs_pt.long()][:, :, None])[:, :, 0] + cam_t[ci]
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    r = Xc[:, :2] / zs[:, None] - xn_obs
    return torch.sum(r * r, dim=-1) + torch.where(z <= 1e-4, 1e6, 0.0)


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------

_RESECT_CHUNK = 32     # cameras per resection call (bounds the (B,H,K) scoring tensors)


def reconstruct(
    kp_uv: np.ndarray,      # (C,K,2) keypoint pixel coords
    kp_mask: np.ndarray,    # (C,K)
    tt: TrackTable,
    intr: np.ndarray,       # (I,7)
    cam_k: np.ndarray,      # (C,) intrinsics index
    cfg: ReconConfig = ReconConfig(),
    callbacks=None,
    pair_counts: tuple | None = None,   # (pairs (Np,2), per-pair match counts)
    *,
    device,
) -> tuple[Scene, dict]:
    """Incremental reconstruction on ``device``: the primary component,
    secondary components while coverage stays under ``coverage_target``,
    the final BA (checkpointed with ``final_ba_ckpt``) and, with
    ``refine_intrinsics``, the joint intrinsics BA.  Returns (Scene on
    ``device``, stats); ``stats["components"]`` has the reference's
    entries, ``stats["component_loop_s"]`` the host wall of the component
    loop and of the BA inside it."""
    device = torch.device(device)
    C, K, _ = kp_uv.shape
    T = tt.n_tracks
    if T == 0:
        raise ReconError("no tracks")
    O = len(tt.obs_cam)
    V = cfg.max_track_views
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    f_mean = float(np.mean(intr[:, :2]))
    # Self-calibrating builds start from a guessed focal: correct geometry
    # then reprojects with errors ~ focal error x radial distance, so the
    # inlier gates stay proportionally lax until the final joint
    # intrinsics BA tightens the model.
    gate_scale = 4.0 if cfg.refine_intrinsics else 1.0
    thresh_n = (gate_scale * cfg.px_thresh / f_mean) ** 2

    def dv(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # Normalized coords for every feature (device, batched).
    intr_d = dv(intr, torch.float32)
    cam_k_d = dv(cam_k, torch.int32)
    xn_feat = cameras.pixel_to_normalized(intr_d[cam_k_d.long()][:, None, :],
                                          dv(kp_uv, torch.float32))            # (C,K,2)
    xn_feat_np = xn_feat.cpu().numpy()

    # Per-track observation slots: (T,V) static SHAPE, dynamic CONTENTS.
    # ``refresh_slots`` re-points each not-yet-alive track's slots at an
    # even spread of its REGISTERED observations before every triangulation
    # round; filling them once with the first V observations would strand
    # long tracks whose first observations lie in an unregistered region.
    starts, ends = tt.track_slices()
    tr_obs_cam = np.zeros((T, V), np.int32)
    tr_obs_feat = np.zeros((T, V), np.int32)
    tr_obs_mask = np.zeros((T, V), bool)

    # Scene obs table == track table (landmark id = track id).
    obs_cam = tt.obs_cam
    obs_pt = tt.obs_track
    obs_uv = kp_uv[obs_cam, tt.obs_feat].astype(np.float32)
    obs_cam_d, obs_pt_d = dv(obs_cam, torch.int32), dv(obs_pt, torch.int32)
    obs_uv_d = dv(obs_uv)
    xn_obs_d = dv(xn_feat_np[obs_cam, tt.obs_feat])

    # Host-side mutable state.
    registered = np.zeros(C, bool)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    X = np.zeros((T, 3), np.float32)
    X_alive = np.zeros(T, bool)
    obs_pruned = np.zeros(O, bool)

    # Per-cam track lists (host, static).
    cam_tracks = [tt.obs_track[obs_cam == c] for c in range(C)]
    cam_feats = [tt.obs_feat[obs_cam == c] for c in range(C)]

    def obs_alive_mask():
        return registered[obs_cam] & X_alive[obs_pt] & ~obs_pruned

    def err2_all():
        return _reproj_err2_norm(dv(cam_R), dv(cam_t), dv(X), obs_cam_d, obs_pt_d,
                                 xn_obs_d).cpu().numpy()

    # ---- initial-pair candidates ------------------------------------------
    # Candidates come from DIRECT per-pair match counts when the pipeline
    # provides them: chained track covisibility is poisoned by drift on long
    # chains.  Without them, fall back to chained covisibility.
    if pair_counts is not None:
        prs_all, pcnt_all = np.asarray(pair_counts[0]), np.asarray(pair_counts[1])
    else:
        cov = np.zeros((C, C), np.int32)
        for s, e in zip(starts, ends):
            cams_in = tt.obs_cam[s:e]
            for i in range(len(cams_in)):
                for j in range(i + 1, len(cams_in)):
                    a, b = cams_in[i], cams_in[j]
                    cov[a, b] += 1
                    cov[b, a] += 1
        au, bu = np.triu_indices(C, k=1)
        prs_all = np.stack([au, bu], axis=1)
        pcnt_all = cov[au, bu]

    def make_pair_order(allowed, focus=None):
        """Seed-candidate pairs restricted to ``allowed`` cameras (and, if
        given, touching at least one ``focus`` camera: a secondary
        component's seed aimed into the uncovered region)."""
        keep = allowed[prs_all[:, 0]] & allowed[prs_all[:, 1]]
        if focus is not None:
            keep &= focus[prs_all[:, 0]] | focus[prs_all[:, 1]]
        prs, pcnt = prs_all[keep], pcnt_all[keep]
        selp = np.flatnonzero(pcnt >= cfg.min_init_inliers)
        selp = selp[np.argsort(-pcnt[selp])]
        if len(selp) > 48:
            # quantile-sample the whole count range: count anti-correlates
            # with baseline, and the top-k alone would be 48 near-zero-
            # baseline neighbors that all fail the parallax gate
            selp = selp[np.round(np.linspace(0, len(selp) - 1, 48)).astype(int)]
        return [(int(a), int(b)) for a, b in prs[selp]]

    def refresh_slots():
        """Re-point dead tracks' V slots at a spread of their registered
        observations (alive tracks keep their slots for stability)."""
        reg_obs = registered[obs_cam] & ~obs_pruned
        nreg = np.bincount(obs_pt[reg_obs], minlength=T)
        for t_i in np.flatnonzero(~X_alive & (nreg >= 2)):
            s, e = starts[t_i], ends[t_i]
            ridx = s + np.flatnonzero(reg_obs[s:e])
            if len(ridx) > V:  # even spread across the (camera-ordered) track
                ridx = ridx[np.round(np.linspace(0, len(ridx) - 1, V)).astype(int)]
            n = len(ridx)
            tr_obs_cam[t_i, :n] = tt.obs_cam[ridx]
            tr_obs_feat[t_i, :n] = tt.obs_feat[ridx]
            tr_obs_mask[t_i, :n] = True
            tr_obs_mask[t_i, n:] = False

    phase_s = {"slots": 0.0, "triangulate": 0.0, "resect_gather": 0.0,
               "resect": 0.0, "ba": 0.0, "eligibility": 0.0}
    stats = {"ransac_inliers": [], "ba_costs": [], "components": [],
             "phase_s": phase_s, "n_rounds": 0, "ba_calls": {"dense": 0, "planes": 0}}

    def run_triangulation():
        t0 = _time.time()
        refresh_slots()
        phase_s["slots"] += _time.time() - t0
        t0 = _time.time()
        Xn, ok = _triangulate_all(dv(cam_R), dv(cam_t), dv(registered), xn_feat, dv(tr_obs_cam),
                                  dv(tr_obs_feat), dv(tr_obs_mask), thresh_n,
                                  cfg.min_parallax_deg)
        ok, Xn = ok.cpu().numpy(), Xn.cpu().numpy()
        newly = ok & ~X_alive
        X[newly] = Xn[newly]
        X_alive[newly] = True
        phase_s["triangulate"] += _time.time() - t0

    def dense_ba_kwargs(obs_pt_s):
        """Settings of the fused dense-layout BA for this call's table.

        tp is the smallest of 8..128 slots per point whose overflow (the
        observations past slot tp of longer tracks) stays under 15 % of the
        table, so the kernels carry the bulk of the work; the overflow rides
        ``lm.ba_solve``'s exact chain with its exact count as ov_cap.  A
        scene whose overflow is the majority even at tp=128 takes the planes
        path."""
        n_obs = len(obs_pt_s)
        if cfg.dense_ba == "off" or (cfg.dense_ba == "auto" and (
                device.type != "cuda" or n_obs < cfg.dense_ba_min_obs)):
            stats["ba_path"] = {"mode": "planes", "why": ("disabled" if cfg.dense_ba == "off"
                                                          else "cpu-or-small")}
            return {}
        lens = np.bincount(obs_pt_s, minlength=T)
        tp = None
        for cand in (8, 16, 32, 64, 128):
            if np.maximum(lens - cand, 0).sum() <= 0.15 * n_obs:
                tp = cand
                break
        if tp is None:
            tp = 128
            if np.maximum(lens - tp, 0).sum() > 0.5 * n_obs:
                stats["ba_path"] = {"mode": "planes", "why": "overflow-majority at tp=128"}
                return {}
        ov = int(np.maximum(lens - tp, 0).sum())
        stats["ba_path"] = {"mode": "dense", "tp": tp, "ov_cap": ov, "obs": n_obs,
                            "overflow_frac": round(ov / max(n_obs, 1), 3)}
        return dict(tp_cap=tp, dense_cg=True, ov_cap=ov)

    def run_ba(iters, ckpt_path=None, huber_scale=1.0, prune=True):
        nonlocal cam_R, cam_t, X
        t_ba = _time.time()
        sel = np.flatnonzero(obs_alive_mask())
        if len(sel) == 0:
            return
        fixed = ~registered
        fixed[np.flatnonzero(registered)[0]] = True
        sel_d = dv(sel)
        ba_args = (intr_d, cam_k_d, dv(cam_R), dv(cam_t), dv(X), obs_cam_d[sel_d],
                   obs_pt_d[sel_d], obs_uv_d[sel_d],
                   torch.ones(len(sel), dtype=torch.float32, device=device), dv(fixed))
        kw = dict(cg_iters=cfg.cg_iters, huber_px=cfg.huber_px * huber_scale,
                  **dense_ba_kwargs(obs_pt[sel]))
        if ckpt_path is not None:
            # the checkpointed final solve: chunks that resume after a crash
            R2, t2, X2, costs = ba_ckpt.ba_solve_checkpointed(
                *ba_args, total_iters=iters, ckpt_every=cfg.final_ba_ckpt_every,
                ckpt_path=ckpt_path, **kw)[:4]
        else:
            R2, t2, X2, costs = lm.ba_solve(*ba_args, iters=iters, **kw)
        cam_R, cam_t, X = R2.cpu().numpy(), t2.cpu().numpy(), X2.cpu().numpy()
        stats["ba_costs"].append([float(costs[0]), float(costs[-1])])
        stats["ba_calls"][stats["ba_path"]["mode"]] += 1
        # cumulative BA throughput of the build, and which path carried it
        wall = _time.time() - t_ba
        phase_s["ba"] += wall
        if len(stats.setdefault("ba_call_s", [])) < 64:
            stats["ba_call_s"].append([len(sel), iters, round(wall, 2)])
        stats["ba_total_s"] = round(stats.get("ba_total_s", 0.0) + wall, 2)
        stats["ba_total_iters"] = stats.get("ba_total_iters", 0) + iters
        stats["ba_iters_per_s"] = round(
            stats["ba_total_iters"] / max(stats["ba_total_s"], 1e-9), 2)
        # prune observations with large error; kill starved points.
        # prune=False is the fusion BA's anneal: right after a sim3 fuse the
        # cross-component observations are exactly the large-residual ones,
        # and pruning them would cut the hinge that constrains the fused
        # geometry
        if prune:
            obs_pruned[:] |= (err2_all() > thresh_n * 4.0) & obs_alive_mask()
            obs_count = np.bincount(obs_pt[obs_alive_mask()], minlength=T)
            X_alive[obs_count < cfg.min_track_views] = False

    def try_seed(pair_order):
        """Score all candidate pairs, trial-BA the best few, keep the best-
        fitting seed.  Returns (ok, diag); on ok the state holds the seeded
        two-view reconstruction."""
        nonlocal cam_R, cam_t, X
        best = None  # (med_px, (a, b), state snapshot)
        if not pair_order:
            return False, "no candidates proposed"
        nc = len(pair_order)
        xa_b = np.zeros((nc, K, 2), np.float32)
        xb_b = np.zeros((nc, K, 2), np.float32)
        valid_b = np.zeros((nc, K), bool)
        for ci, (a, b) in enumerate(pair_order):
            shared, ia, ib = np.intersect1d(cam_tracks[a], cam_tracks[b], return_indices=True)
            n = min(len(shared), K)
            xa_b[ci, :n] = xn_feat_np[a, cam_feats[a][ia[:n]]]
            xb_b[ci, :n] = xn_feat_np[b, cam_feats[b][ib[:n]]]
            valid_b[ci, :n] = True
        g = ransac.gumbel_noise((nc, cfg.ransac_hypotheses, K), device=device, generator=gen)
        Rc, tc, _inlc, cntc, parc = _init_pair_batch(g, dv(xa_b), dv(xb_b), dv(valid_b), thresh_n)
        Rc, tc = Rc.cpu().numpy(), tc.cpu().numpy()
        cntc, parc = cntc.cpu().numpy(), parc.cpu().numpy()
        # gate: enough E-inliers and a median triangulation angle in a sane band
        passing = ((cntc >= cfg.min_init_inliers)
                   & (parc > cfg.min_parallax_deg) & (parc < 60.0))
        # Seed-quality selection: a geometrically passing but degenerate
        # seed (an oblique view of one plane) drags the reconstruction into
        # an optimum later BAs cannot leave, so BA each candidate's two-view
        # seed and keep the best-FITTING of the first few that triangulate.
        # Trial order weights inliers by (capped) parallax and mild frame
        # centrality: raw inlier counts surface ADJACENT frames (near-zero
        # baseline), and an END seed doubles the frontier distance.
        mid = np.array([(a + b) for (a, b) in pair_order], np.float64) / 2.0
        central = 1.0 - 0.6 * np.abs(mid - C / 2.0) / max(C / 2.0, 1)
        trial_score = np.where(passing, cntc * np.minimum(parc, 15.0) * central, -1.0)
        trials = 0
        for ci in np.argsort(-trial_score):
            if not passing[ci] or trials >= 3:
                break
            a, b = pair_order[ci]
            cam_R[a], cam_t[a] = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            cam_R[b], cam_t[b] = Rc[ci], tc[ci]
            registered[a] = registered[b] = True
            pruned_snap = obs_pruned.copy()
            run_triangulation()
            if X_alive.sum() >= max(8, cfg.min_init_inliers // 2):
                trials += 1
                run_ba(cfg.ba_iters)
                med_px = _med_reproj_px()
                n_pts = int(X_alive.sum())
                if (n_pts >= max(8, cfg.min_init_inliers // 2) and med_px < cfg.px_thresh
                        and (best is None or med_px < best[0])):
                    best = (med_px, (int(a), int(b)),
                            (cam_R.copy(), cam_t.copy(), X.copy(), X_alive.copy(),
                             obs_pruned.copy()))
            # reset to the pre-init state for the next trial
            registered[a] = registered[b] = False
            X_alive[:] = False
            obs_pruned[:] = pruned_snap
        if best is None:
            diag = (f"{len(pair_order)} candidates: "
                    f"{int((cntc >= cfg.min_init_inliers).sum())} passed the "
                    f"inlier gate (>= {cfg.min_init_inliers}; max {int(cntc.max())}), "
                    f"{int(passing.sum())} also passed the parallax band "
                    f"({cfg.min_parallax_deg}-60 deg; median "
                    f"{float(np.nanmedian(parc)):.2f} deg, max {float(np.nanmax(parc)):.2f})")
            return False, diag
        med_px, (a, b), (cam_R, cam_t, X, X_alive[:], obs_pruned[:]) = best
        registered[a] = registered[b] = True
        stats.setdefault("init_pairs", []).append((a, b, round(med_px, 4)))
        return True, None

    # ---- incremental loop --------------------------------------------------
    # Round-based: every round resects either the single best camera (the
    # classical sequential engine) or ALL eligible cameras at once in one
    # batched device call (batch_resection, the scalable default).
    failed = np.zeros(C, bool)
    points_at_failure = np.full(C, -1.0)

    def incremental_loop(allowed):
        n_since_ba = 0
        while True:
            t0 = _time.time()
            stats["n_rounds"] += 1
            counts = np.array([
                0 if (registered[c] or not allowed[c]) else int(X_alive[cam_tracks[c]].sum())
                for c in range(C)
            ])
            # Failed cameras become eligible again once the structure THEY
            # see has grown 25% (or by 15 points) since their failure; a
            # global-growth trigger never fires for a frontier expanding
            # into a new region.
            retry = failed & (points_at_failure >= 0) & (
                (counts > 1.25 * points_at_failure) | (counts > points_at_failure + 15))
            failed[retry] = False
            counts[failed] = 0
            eligible = np.where(counts >= cfg.min_resection_inliers)[0]
            if len(eligible) == 0:
                break
            if cfg.batch_resection:
                # only well-supported cameras each round: weakly covered
                # views wait for BA-consolidated structure
                gate = max(cfg.min_resection_inliers, 0.5 * counts.max())
                eligible = eligible[counts[eligible] >= gate]
            else:
                eligible = eligible[np.argsort(counts[eligible])[::-1][:1]]
            phase_s["eligibility"] += _time.time() - t0
            t0 = _time.time()

            nb = len(eligible)
            xs = np.zeros((nb, K, 2), np.float32)
            Xs = np.zeros((nb, K, 3), np.float32)
            valid = np.zeros((nb, K), bool)
            sels = []
            for bi, c in enumerate(eligible):
                sel = X_alive[cam_tracks[c]]
                n = min(int(sel.sum()), K)
                feats_sel = cam_feats[c][sel][:n]
                tracks_sel = cam_tracks[c][sel][:n]
                xs[bi, :n] = xn_feat_np[c, feats_sel]
                Xs[bi, :n] = X[tracks_sel]
                valid[bi, :n] = True
                sels.append(tracks_sel)
            phase_s["resect_gather"] += _time.time() - t0
            t0 = _time.time()
            parts = []
            for s in range(0, nb, _RESECT_CHUNK):
                e = min(s + _RESECT_CHUNK, nb)
                g = ransac.gumbel_noise((e - s, cfg.ransac_hypotheses, K), device=device,
                                        generator=gen)
                parts.append(_resect_batch(g, dv(xs[s:e]), dv(Xs[s:e]), dv(valid[s:e]),
                                           thresh_n, cfg.resection_solver))
            Rb, tb, inlb, cntb = (torch.cat(x).cpu().numpy() for x in zip(*parts))
            phase_s["resect"] += _time.time() - t0
            for bi, c in enumerate(eligible):
                if int(cntb[bi]) < cfg.min_resection_inliers:
                    failed[c] = True
                    # the alive-structure count THIS camera saw at failure
                    points_at_failure[c] = counts[c]
                    continue
                cam_R[c] = Rb[bi]
                cam_t[c] = tb[bi]
                registered[c] = True
                stats["ransac_inliers"].append(int(cntb[bi]))
                tracks_sel = sels[bi]
                bad_tracks = tracks_sel[~inlb[bi][: len(tracks_sel)]]
                if len(bad_tracks):
                    bad = (obs_cam == c) & np.isin(obs_pt, bad_tracks)
                    obs_pruned[bad] = True

            run_triangulation()
            n_since_ba += 1
            if n_since_ba >= cfg.ba_every or cfg.batch_resection:
                run_ba(cfg.ba_iters)
                n_since_ba = 0
            if callbacks:
                callbacks(registered.copy(), X_alive.copy())

    def _med_reproj_px():
        alive_m = obs_alive_mask()
        if not alive_m.any():
            return float("inf")
        return float(np.sqrt(np.median(err2_all()[alive_m]))) * f_mean

    # ---- primary component -------------------------------------------------
    all_cams = np.ones(C, bool)
    ok, seed_diag = try_seed(make_pair_order(all_cams))
    if not ok:
        raise ReconError(
            f"no valid initial pair (all candidates failed to seed): {seed_diag}")
    stats["init_pair"] = stats["init_pairs"][0][:2]
    stats["init_med_px"] = stats["init_pairs"][0][2]
    incremental_loop(all_cams)
    stats["components"].append({"component": 0, "registered": int(registered.sum())})

    # ---- secondary components: multi-seed coverage recovery ----------------
    # A stalled frontier is recovered by seeding a NEW component among the
    # unregistered cameras + a bridge of covisible registered ones, growing
    # it with the same machinery, and fusing it into the primary through
    # the VERIFIED shared-track / shared-camera similarity.  A registration
    # failure drops the component (diagnostics recorded), never a blind
    # stitch.
    t_comp, ba_s0 = _time.time(), phase_s["ba"]
    has_tracks = np.array([len(cam_tracks[c]) > 0 for c in range(C)])
    n_possible = max(int(has_tracks.sum()), 1)
    comp = 1
    # a rolled-back fusion retries ONCE with a doubled bridge: the failure
    # mode is a too-thin hinge, and more bridge cameras give the secondary
    # more shared structure to anchor and more cross-observations
    fuse_attempts = 0
    bridge_n = cfg.bridge_cams

    def snapshot():
        """Every piece of host state the component loop mutates (run_ba
        rebinds cam_R, cam_t and X; the rest change in place)."""
        return (registered.copy(), failed.copy(), points_at_failure.copy(), cam_R.copy(),
                cam_t.copy(), X.copy(), X_alive.copy(), obs_pruned.copy())

    def restore(snap):
        (registered[:], failed[:], points_at_failure[:], cam_R[:], cam_t[:], X[:],
         X_alive[:], obs_pruned[:]) = snap

    def component_failed(entry):
        nonlocal fuse_attempts, bridge_n
        stats["components"].append(entry)
        fuse_attempts += 1
        bridge_n *= 2
        return fuse_attempts >= 2

    while comp < cfg.max_components and registered.sum() < cfg.coverage_target * n_possible:
        U = has_tracks & ~registered
        if U.sum() < max(4, cfg.min_init_inliers // 4):
            break
        snap = snapshot()
        # bridge: the registered cameras with the strongest direct matches
        # into the uncovered set (shared structure to register against)
        bscore = np.zeros(C, np.int64)
        in_u_a, in_u_b = U[prs_all[:, 0]], U[prs_all[:, 1]]
        reg_a, reg_b = registered[prs_all[:, 0]], registered[prs_all[:, 1]]
        np.add.at(bscore, prs_all[in_u_a & reg_b, 1], pcnt_all[in_u_a & reg_b])
        np.add.at(bscore, prs_all[in_u_b & reg_a, 0], pcnt_all[in_u_b & reg_a])
        bridge = np.zeros(C, bool)
        top_b = np.argsort(-bscore)[:bridge_n]
        bridge[top_b] = bscore[top_b] > 0
        allowed2 = U | bridge
        # fresh state for the secondary component
        registered[:] = False
        failed[:] = False
        points_at_failure[:] = -1.0
        X_alive[:] = False
        obs_pruned[:] = False
        ok2, diag2 = try_seed(make_pair_order(allowed2, focus=U))
        if ok2:
            incremental_loop(allowed2)
        reg_sec, camR_sec, camt_sec, X_sec, Xalive_sec = (
            registered.copy(), cam_R.copy(), cam_t.copy(), X.copy(), X_alive.copy())
        restore(snap)  # the primary again
        new_cams = reg_sec & ~registered
        if not ok2 or int(new_cams.sum()) == 0:
            if component_failed({"component": comp,
                                 "fail": diag2 or "secondary registered no new cameras"}):
                break
            continue
        shared_t = X_alive & Xalive_sec
        shared_c = registered & reg_sec
        Pa_l, Pb_l = [X[shared_t]], [X_sec[shared_t]]
        if shared_c.any():
            Pa_l.append(-np.einsum("cji,cj->ci", cam_R[shared_c], cam_t[shared_c]))
            Pb_l.append(-np.einsum("cji,cj->ci", camR_sec[shared_c], camt_sec[shared_c]))
        try:
            if int(shared_c.sum()) >= 3:
                # rotation anchored on shared camera orientations: the shared
                # structure concentrates at the frontier, where point-only
                # Umeyama is rotation/scale-degenerate; the post-fusion BA
                # check below is the authoritative accept/rollback, so the
                # split-half gate is off
                reg = register_rigid_anchored(
                    cam_R[shared_c], camR_sec[shared_c], np.concatenate(Pa_l),
                    np.concatenate(Pb_l), min_point_inliers=max(8, cfg.min_init_inliers // 3),
                    agree_scale=None, agree_trans_frac=None)
            else:
                reg = register_points_verified(
                    np.concatenate(Pa_l), np.concatenate(Pb_l), device=device, noise=gen,
                    min_inliers=max(8, cfg.min_init_inliers // 3))
        except RegistrationError as e:
            if component_failed({"component": comp, "new_cams": int(new_cams.sum()),
                                 "fail": f"sim3 verification: {e}"}):
                break
            continue

        pre_med_px = _med_reproj_px()
        pre_snap = snapshot()
        # fuse: secondary poses/points into the primary frame (B->A world
        # similarity: R' = Rc R^T, t' = s tc - R' t, X' = s R X + t)
        X2 = reg.s * (X_sec @ reg.R.T) + reg.t
        R2 = np.einsum("cij,kj->cik", camR_sec, reg.R)
        t2 = reg.s * camt_sec - np.einsum("cij,j->ci", R2, reg.t)
        cam_R[new_cams] = R2[new_cams]
        cam_t[new_cams] = t2[new_cams]
        registered[new_cams] = True
        new_pts = Xalive_sec & ~X_alive
        X[new_pts] = X2[new_pts]
        X_alive[new_pts] = True
        # a shared track whose two points the similarity does not map onto
        # each other (a RANSAC outlier) is killed, and comes back only if
        # it re-triangulates within px_thresh in every registered view
        # under the fused poses.  One false match joins a point of each
        # component into one track; kept at the primary's point, the other
        # component's views see it with hundreds of px of error, and its
        # Huber tail alone bent a noise-free 96-camera fusion to an ATE of
        # 0.9 in a world 12 across (F8 in ROADMAP.md; the reference keeps
        # such tracks)
        X_alive[np.flatnonzero(shared_t)[~reg.inliers[:int(shared_t.sum())]]] = False
        failed[:] = False
        points_at_failure[:] = -1.0
        run_triangulation()
        # Annealed-Huber fusion BA, pruning deferred: a slightly-off sim3
        # puts the cross-component residuals past huber_px, where Huber's
        # linear tail barely pulls; widening it first makes the hinge
        # quadratic so the long-wavelength correction happens.  25
        # iterations a stage: a degree of hinge error bends the far end.
        fuse_iters = max(cfg.ba_iters, 25)
        run_ba(fuse_iters, huber_scale=8.0, prune=False)
        run_ba(fuse_iters, huber_scale=2.0, prune=False)
        run_ba(fuse_iters, prune=False)
        # the authoritative fusion verification: joint BA either absorbs the
        # disagreement (reprojection returns to the pre-fusion level) or
        # cannot (the fused frontier is wrong): roll back then.  The floor
        # is 0.25 * px_thresh = 1 px.
        post_med_px = _med_reproj_px()
        if post_med_px > max(1.5 * pre_med_px, 0.25 * cfg.px_thresh):
            restore(pre_snap)
            if component_failed({"component": comp, "new_cams": int(new_cams.sum()),
                                 "fail": ("post-fusion BA verification: median reprojection "
                                          f"{pre_med_px:.2f} -> {post_med_px:.2f} px; "
                                          "rolled back")}):
                break
            continue
        stats["components"].append(
            {"component": comp, "new_cams": int(new_cams.sum()),
             "new_points": int(new_pts.sum()), "reg_inliers": int(reg.inliers.sum()),
             "shared_tracks": int(shared_t.sum()), "shared_cams": int(shared_c.sum()),
             "med_px": [round(pre_med_px, 3), round(post_med_px, 3)]})
        # fused structure may unlock previously stalled cameras everywhere
        incremental_loop(all_cams)
        comp += 1
        fuse_attempts = 0
        bridge_n = cfg.bridge_cams
    stats["component_loop_s"] = {"wall": round(_time.time() - t_comp, 3),
                                 "ba": round(phase_s["ba"] - ba_s0, 3)}

    run_ba(cfg.final_ba_iters, ckpt_path=cfg.final_ba_ckpt)

    if cfg.refine_intrinsics:
        # final joint pose+point+intrinsics LM (self-calibration): focal and
        # distortion errors trade off against depth and are invisible to
        # alternating refinement
        sel_d = dv(np.flatnonzero(obs_alive_mask()))
        fixedm = ~registered
        fixedm[np.flatnonzero(registered)[0]] = True
        R2, t2, X2, intr2, costs = lm.ba_solve_intrinsics(
            intr_d, cam_k_d, dv(cam_R), dv(cam_t), dv(X), obs_cam_d[sel_d], obs_pt_d[sel_d],
            obs_uv_d[sel_d], torch.ones(len(sel_d), dtype=torch.float32, device=device),
            dv(fixedm), params=tuple(cfg.refine_intrinsics), iters=cfg.final_ba_iters,
            cg_iters=cfg.cg_iters, huber_px=cfg.huber_px)
        cam_R, cam_t, X = R2.cpu().numpy(), t2.cpu().numpy(), X2.cpu().numpy()
        intr = intr2.cpu().numpy()
        stats["refined_intrinsics"] = intr.tolist()
        # costs[i+1] is iteration i's best trial, taken or not (a non-finite
        # trial is never taken); the state's cost is the least finite entry
        stats["intrinsics_ba_costs"] = [float(costs[0]),
                                        float(costs[torch.isfinite(costs)].min())]

    scene = new_scene(C, T, O, intr, cam_k=cam_k, device=device)
    scene = dataclasses.replace(
        scene, cam_R=dv(cam_R), cam_t=dv(cam_t), cam_alive=dv(registered),
        X=dv(X), X_alive=dv(X_alive), obs_cam=obs_cam_d, obs_pt=obs_pt_d,
        obs_uv=obs_uv_d, obs_alive=dv(obs_alive_mask()))
    stats["n_registered"] = int(registered.sum())
    stats["n_points"] = int(X_alive.sum())
    stats["final_med_px"] = round(_med_reproj_px(), 4)
    stats["phase_s"] = {k: round(v, 2) for k, v in phase_s.items()}
    return scene, stats
