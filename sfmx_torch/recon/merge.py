"""Multi-session map merge: cross-registration, fusion, joint BA (port of
``sfmx.recon.merge``).

Every session pair is registered through ``recon.register`` (support gate,
split-half stability, cross-reprojection, retried across thresholds and
draws; RegistrationError on exhaustion).  Sessions compose into the first
session's frame along the maximum-inlier spanning tree of the verified
registration graph, matched landmark pairs are fused (one landmark id,
observations remapped) under a conflict rule, and one joint bundle
adjustment runs on the planes path, as in the reference.  Registration is
host numpy but for its RANSAC, which runs on the scenes' device; the
merged ``Scene`` is returned on that device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mapstore.scene import Scene
from ..solvers import lm, umeyama
from .register import RegistrationError, noise_source, ransac_sim3, register_landmarks_verified


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def landmark_descriptors(scene: Scene, feat_desc, obs_feat):
    """Mean per-landmark descriptor over alive observations, normalized
    (host side)."""
    feat_desc, obs_feat = _np(feat_desc), _np(obs_feat)
    obs_cam = _np(scene.obs_cam)
    obs_pt = _np(scene.obs_pt)
    alive = _np(scene.obs_alive)
    P, D = scene.X.shape[0], feat_desc.shape[-1]
    acc = np.zeros((P, D), np.float32)
    cnt = np.zeros(P, np.float32)
    np.add.at(acc, obs_pt[alive], feat_desc[obs_cam[alive], obs_feat[alive]])
    np.add.at(cnt, obs_pt[alive], 1.0)
    acc /= np.maximum(cnt[:, None], 1.0)
    n = np.linalg.norm(acc, axis=1, keepdims=True)
    return acc / np.maximum(n, 1e-8)


def register_pair(Xa, desc_a, alive_a, Xb, desc_b, alive_b, *, device, noise=None,
                  ratio: float = 0.9, k_hypotheses: int = 2048,
                  inlier_frac_of_extent: float = 0.02):
    """Estimate the sim3 taking scene B coords into scene A's frame
    (unverified: one RANSAC on ``device`` with one draw of ``noise``, see
    ``register.noise_source``, then Umeyama on its inliers).

    Returns (s, R, t, pairs (M,2) matched landmark ids, inlier_mask (M,)).
    """
    sim = desc_a @ desc_b.T
    sim[~alive_a] = -2
    sim[:, ~alive_b] = -2
    best_b = sim.argmax(1)
    best_s = sim.max(1)
    mutual = sim.argmax(0)[best_b] == np.arange(len(desc_a))
    cand = (best_s > 0.7) & mutual & alive_a
    ia = np.where(cand)[0]
    ib = best_b[ia]
    if len(ia) < 3:
        raise ValueError(f"too few cross-session landmark matches: {len(ia)}")
    extent = float(np.linalg.norm(Xa[alive_a].max(0) - Xa[alive_a].min(0)))
    thresh = (inlier_frac_of_extent * extent) ** 2
    gumbel = noise_source(noise, device)((k_hypotheses, len(ia)))
    inliers, _ = ransac_sim3(gumbel, Xa[ia], Xb[ib], thresh)
    # refine on the inliers
    Pa = torch.as_tensor(np.asarray(Xa[ia], np.float32), device=gumbel.device)
    Pb = torch.as_tensor(np.asarray(Xb[ib], np.float32), device=gumbel.device)
    s, R, t = umeyama.umeyama(Pb, Pa, torch.as_tensor(inliers, device=gumbel.device))
    pairs = np.stack([ia, ib], axis=1)
    return float(s), R.cpu().numpy(), t.cpu().numpy(), pairs, inliers


def transform_scene_inplace(cam_R, cam_t, X, s, R, t):
    """Apply the world similarity (B->A) to poses and points of scene B.

    New pose: R' = Rc R^T, t' = s*tc - R' t (keeps pixel projections, depths
    scale by s)."""
    X2 = s * (X @ R.T) + t
    R2 = np.einsum("cij,kj->cik", cam_R, R)  # Rc @ R^T
    t2 = s * cam_t - np.einsum("cij,j->ci", R2, t)
    return R2, t2, X2


def merge_scenes(sessions, *, ba_iters: int = 20, cg_iters: int = 40,
                 huber_px: float = 4.0, seed: int = 0, reproj_px: float = 10.0,
                 noise=None):
    """Merge session maps into one scene + joint BA.

    sessions: list of (Scene, feat_desc (C,K,D), kp_uv, kp_mask, obs_feat),
    the scenes on one device.  The first session defines the output frame.
    ``noise``: None (a generator on the scenes' device seeded ``seed``
    draws every edge's attempts in turn), or a callable ``(i, j) ->`` the
    noise of edge (i, j) as ``register.noise_source`` takes it.

    Raises RegistrationError (with per-pair diagnostics) when the verified
    registration graph does not connect every session.
    """
    device = sessions[0][0].X.device
    if noise is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        edge_noise = lambda i, j: gen
    else:
        edge_noise = noise
    N = len(sessions)
    stats = {"n_sessions": N, "pair_inliers": [], "edges": [], "failed_edges": []}

    # Per-session numpy state.
    st = []
    for scene, desc, _kp_uv, _kp_mask, obs_feat in sessions:
        cols = scene.to_numpy()
        st.append({
            "R": cols["cam_R"], "t": cols["cam_t"], "X": cols["X"], "Xa": cols["X_alive"],
            "cam_alive": cols["cam_alive"], "cam_k": cols["cam_k"],
            "obs_cam": cols["obs_cam"], "obs_pt": cols["obs_pt"], "obs_uv": cols["obs_uv"],
            "obs_alive": cols["obs_alive"], "intr": cols["intr"],
            "ldesc": landmark_descriptors(scene, desc, obs_feat),
        })

    # --- registration graph: every session pair, verified -------------------
    edges = {}  # (i,j) -> RegResult (sim3 j->i)
    for i in range(N):
        for j in range(i + 1, N):
            try:
                reg = register_landmarks_verified(
                    st[i]["X"], st[i]["ldesc"], st[i]["Xa"],
                    st[j]["X"], st[j]["ldesc"], st[j]["Xa"],
                    scene_a=st[i], scene_b=st[j], device=device, noise=edge_noise(i, j),
                    reproj_px=reproj_px)
                edges[(i, j)] = reg
                stats["edges"].append(
                    {"pair": (i, j), "inliers": int(reg.inliers.sum()),
                     **{k: v for k, v in reg.diag.items() if k in ("reproj_px", "inlier_frac")}})
            except RegistrationError as e:
                stats["failed_edges"].append({"pair": (i, j), "attempts": e.attempts})

    # --- maximum-inlier spanning tree from session 0 ------------------------
    in_tree = {0}
    tree: list[tuple[int, int]] = []  # (parent_in_tree, child)
    while len(in_tree) < N:
        best = None
        for (i, j), reg in edges.items():
            w = int(reg.inliers.sum())
            if (i in in_tree) != (j in in_tree):
                parent, child = (i, j) if i in in_tree else (j, i)
                if best is None or w > best[0]:
                    best = (w, parent, child)
        if best is None:
            missing = sorted(set(range(N)) - in_tree)
            raise RegistrationError(
                f"registration graph disconnected: sessions {missing} have "
                f"no verified edge into the merged component "
                f"({len(edges)} verified / {len(stats['failed_edges'])} failed edges)",
                [a for fe in stats["failed_edges"] for a in fe["attempts"]])
        _, parent, child = best
        in_tree.add(child)
        tree.append((parent, child))
    stats["tree"] = tree
    stats["pair_inliers"] = [int(edges[e].inliers.sum()) for e in sorted(edges)]

    # --- compose similarities into the root frame along the tree ------------
    # T[i] = (s,R,t) taking session-i coords into session-0 coords
    T = {0: (1.0, np.eye(3), np.zeros(3))}
    changed = True
    while changed:
        changed = False
        for parent, child in tree:
            if child in T or parent not in T:
                continue
            sp, Rp, tp = T[parent]
            if (parent, child) in edges:
                r = edges[(parent, child)]  # child -> parent
                sc_, Rc, tc = r.s, r.R, r.t
            else:
                r = edges[(child, parent)]  # parent -> child: invert
                sc_ = 1.0 / r.s
                Rc = r.R.T
                tc = -(Rc @ r.t) / r.s
            T[child] = (sp * sc_, Rp @ Rc, sp * (Rp @ tc) + tp)
            changed = True

    for i in range(1, N):
        s, R, t = T[i]
        st[i]["R"], st[i]["t"], st[i]["X"] = transform_scene_inplace(
            st[i]["R"], st[i]["t"], st[i]["X"], s, R, t)

    # --- landmark fusion across ALL verified edges --------------------------
    # conflict-aware union-find over (session, landmark): a component holds
    # at most one landmark per session, so a union whose components share a
    # session is an aliased match and is rejected (the track builder's rule)
    P_sizes = [len(s_i["X"]) for s_i in st]
    pt_offsets = np.concatenate([[0], np.cumsum(P_sizes)]).astype(np.int64)
    parent = {}
    sess_sets = {}

    def find(x):
        r = x
        while parent.get(r, r) != r:
            r = parent[r]
        while parent.get(x, x) != r:
            parent[x], x = r, parent[x]
        return r

    def sset(root, default_session):
        if root not in sess_sets:
            sess_sets[root] = {default_session}  # fresh singleton component
        return sess_sets[root]

    for (i, j), reg in edges.items():
        for (a, b), ok in zip(reg.pairs, reg.inliers):
            if not ok:
                continue
            ga = int(pt_offsets[i] + a)
            gb = int(pt_offsets[j] + b)
            ra, rb = find(ga), find(gb)
            if ra == rb:
                continue
            sa = sset(ra, i)
            sb = sset(rb, j)
            if sa & sb:
                continue  # aliased: two landmarks of one session
            rn, ro = (ra, rb) if len(sa) >= len(sb) else (rb, ra)
            parent[ro] = rn
            sess_sets[rn] = sa | sb
            sess_sets.pop(ro, None)

    # --- concatenate into one table; fused landmarks share the root id -----
    cam_off, intr_off = 0, 0
    Rs, ts, cam_alive, cam_k, Xs, Xa, intrs = [], [], [], [], [], [], []
    obs_cam, obs_pt, obs_uv, obs_alive = [], [], [], []
    fused = {g: find(g) for g in parent}  # only fused landmarks remap
    for i, s_i in enumerate(st):
        C, P = len(s_i["R"]), len(s_i["X"])
        pt_map = np.arange(P, dtype=np.int64) + pt_offsets[i]
        Xa_i = s_i["Xa"].copy()
        for g, r in fused.items():
            if pt_offsets[i] <= g < pt_offsets[i + 1] and r != g:
                loc = g - pt_offsets[i]
                pt_map[loc] = r
                Xa_i[loc] = False  # fused away: the root row carries the point
        Rs.append(s_i["R"])
        ts.append(s_i["t"])
        cam_alive.append(s_i["cam_alive"])
        cam_k.append(s_i["cam_k"] + intr_off)
        Xs.append(s_i["X"])
        Xa.append(Xa_i)
        intrs.append(s_i["intr"])
        obs_cam.append(s_i["obs_cam"] + cam_off)
        obs_pt.append(pt_map[s_i["obs_pt"]])
        obs_uv.append(s_i["obs_uv"])
        obs_alive.append(s_i["obs_alive"])
        cam_off += C
        intr_off += len(s_i["intr"])

    def dv(parts, dtype):
        return torch.as_tensor(np.concatenate(parts), device=device).to(dtype)

    merged = Scene(
        intr=dv(intrs, torch.float32), cam_k=dv(cam_k, torch.int32),
        cam_R=dv(Rs, torch.float32), cam_t=dv(ts, torch.float32),
        cam_alive=dv(cam_alive, torch.bool), X=dv(Xs, torch.float32),
        X_alive=dv(Xa, torch.bool), obs_cam=dv(obs_cam, torch.int32),
        obs_pt=dv(obs_pt, torch.int32), obs_uv=dv(obs_uv, torch.float32),
        obs_alive=dv(obs_alive, torch.bool))

    # Joint global BA (the reference's final merge step), on the planes path.
    fixed = ~merged.cam_alive
    first = torch.nonzero(merged.cam_alive)[:, 0]
    if len(first):
        fixed[first[0]] = True
    R2, t2, X2, costs = lm.ba_solve(
        merged.intr, merged.cam_k, merged.cam_R, merged.cam_t, merged.X,
        merged.obs_cam, merged.obs_pt, merged.obs_uv, merged.obs_alive.to(torch.float32),
        fixed, iters=ba_iters, cg_iters=cg_iters, huber_px=huber_px)
    merged = dataclasses.replace(merged, cam_R=R2, cam_t=t2, X=X2)
    stats["joint_ba_cost"] = [float(costs[0]), float(costs[-1])]
    stats["n_cameras"] = int(merged.cam_alive.sum())
    stats["n_points"] = int(merged.X_alive.sum())
    return merged, stats
