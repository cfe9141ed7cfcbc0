"""P3P minimal solver: Grunert's quartic, branch-free for batched RANSAC
(port of ``sfmx.solvers.p3p``).

A 3-point minimal sample makes RANSAC survive low inlier ratios: at inlier
ratio w a hypothesis succeeds with probability w^3, against w^6 for the
6-point DLT.  Everything is fixed-shape elementwise work over any leading
batch axes:

- Grunert's quartic coefficients per sample;
- all four roots from Ferrari's closed form in manual complex arithmetic
  over (re, im) pairs, each real part then polished by fixed-iteration
  Newton on the real quartic;
- depths from the law of cosines, Newton-polished on the full system;
- one pose per root by the TRIAD method (the triangle's orthonormal frame
  in both coordinate systems; no SVD).

Complex-pair or degenerate roots give finite garbage poses that score no
inliers, so RANSAC's argmax does the root selection.  ``p3p_minimal``
returns all 4 candidates per sample; ``ransac.ransac(n_candidates=4)``
joins them to the hypothesis axis.
"""
from __future__ import annotations

import torch

MIN_SAMPLE = 3
N_CANDIDATES = 4

_EPS = 1e-12


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cdiv(a, b):
    d = torch.clamp(b[0] * b[0] + b[1] * b[1], min=_EPS)
    return (a[0] * b[0] + a[1] * b[1]) / d, (a[1] * b[0] - a[0] * b[1]) / d


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _csqrt(a):
    """Principal square root via polar form."""
    r = torch.hypot(a[0], a[1])
    th = torch.atan2(a[1], a[0])
    s = torch.sqrt(r)
    return s * torch.cos(0.5 * th), s * torch.sin(0.5 * th)


def _ccbrt(a):
    """Principal cube root via polar form."""
    r = torch.hypot(a[0], a[1])
    th = torch.atan2(a[1], a[0])
    s = _cbrt(r)
    return s * torch.cos(th / 3.0), s * torch.sin(th / 3.0)


def quartic_roots(coeffs: torch.Tensor, polish_iters: int = 12) -> torch.Tensor:
    """Real parts of the 4 roots of real quartics, Newton-polished.

    coeffs (...,5), highest degree first -> (...,4).  Complex-conjugate
    pairs yield real parts that polish to wherever Newton drifts; the
    poses they give score no inliers downstream.
    """
    A4 = coeffs[..., 0]
    # sign-preserving clamp of a degenerate leading coefficient: a wrong but
    # finite root instead of inf/nan
    scale = torch.amax(torch.abs(coeffs), dim=-1)
    A4s = torch.where(torch.abs(A4) < 1e-9 * scale,
                      torch.where(A4 < 0, -1e-9 * scale, 1e-9 * scale), A4)
    a, b, c, d = (coeffs[..., i] / A4s for i in range(1, 5))
    zero = torch.zeros_like(a)
    one = torch.ones_like(a)

    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - 0.5 * a * b + a * a * a / 8.0
    r = d - 0.25 * a * c + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0

    # resolvent cubic m^3 + P m^2 + Q m + S = 0, depressed: w^3 + pw w + qw = 0
    P, Q, S = p, 0.25 * p * p - r, -q * q / 8.0
    pw = Q - P * P / 3.0
    qw = 2.0 * P ** 3 / 27.0 - P * Q / 3.0 + S
    disc = _csqrt((qw * qw / 4.0 + pw ** 3 / 27.0, zero))
    u = _ccbrt((-0.5 * qw + disc[0], disc[1]))
    # w = u - pw/(3u); guard u ~ 0 (then w = cbrt(-qw))
    u_small = torch.hypot(u[0], u[1]) < 1e-20
    u = (torch.where(u_small, one, u[0]), torch.where(u_small, zero, u[1]))
    inv_u = _cdiv((one, zero), u)
    w = (u[0] - pw / 3.0 * inv_u[0], u[1] - pw / 3.0 * inv_u[1])
    w = (torch.where(u_small, _cbrt(-qw), w[0]), torch.where(u_small, zero, w[1]))
    m = (w[0] - P / 3.0, w[1])

    # s = sqrt(2m); guard m ~ 0 (biquadratic case), Newton absorbs the nudge
    m = (torch.where(torch.hypot(m[0], m[1]) < 1e-12, torch.full_like(m[0], 1e-12), m[0]),
         m[1])
    s = _csqrt((2.0 * m[0], 2.0 * m[1]))
    t_half = (0.5 * p + m[0], m[1])
    q_2s = _cdiv((q, zero), (2.0 * s[0], 2.0 * s[1]))
    s2 = _cmul(s, s)

    def quad(sgn):
        # y^2 - sgn*s y + (p/2 + m + sgn*q/(2s)) = 0
        cterm = (t_half[0] + sgn * q_2s[0], t_half[1] + sgn * q_2s[1])
        dq = _csqrt((s2[0] - 4.0 * cterm[0], s2[1] - 4.0 * cterm[1]))
        return 0.5 * (sgn * s[0] + dq[0]), 0.5 * (sgn * s[0] - dq[0])

    ya, yb = quad(1.0)
    yc, yd = quad(-1.0)
    x = torch.stack([ya, yb, yc, yd], dim=-1) - 0.25 * a[..., None]

    a_, b_, c_, d_ = (v[..., None] for v in (a, b, c, d))
    for _ in range(polish_iters):
        f = (((x + a_) * x + b_) * x + c_) * x + d_
        fp = ((4.0 * x + 3.0 * a_) * x + 2.0 * b_) * x + c_
        fp = torch.where(torch.abs(fp) < _EPS, torch.where(fp < 0, -_EPS, _EPS), fp)
        x = x - f / fp
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _frame(p1, p2, p3):
    """Orthonormal frame (columns) of the triangle p1 p2 p3 (...,3 each)."""
    e1 = p2 - p1
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True), min=_EPS)
    n = torch.linalg.cross(e1, p3 - p1, dim=-1)
    e3 = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=_EPS)
    return torch.stack([e1, torch.linalg.cross(e3, e1, dim=-1), e3], dim=-1)


def p3p_minimal(xn: torch.Tensor, X: torch.Tensor):
    """Grunert P3P: 3 normalized image points + 3 world points -> 4 poses.

    xn (...,3,2) undistorted normalized coords, X (...,3,3) world points.
    Returns world-to-camera (R (...,4,3,3), t (...,4,3)).  Degenerate
    samples give finite garbage candidates that RANSAC scoring discards.
    """
    f = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)      # (...,3,3) rays
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    X0, X1, X2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]

    a2 = torch.sum((X1 - X2) ** 2, dim=-1)   # side opposite P1
    b2 = torch.clamp(torch.sum((X0 - X2) ** 2, dim=-1), min=_EPS)
    c2 = torch.sum((X0 - X1) ** 2, dim=-1)
    ca = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)
    cb = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)
    cg = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)

    q1 = (a2 - c2) / b2
    q2 = (a2 + c2) / b2
    q3 = (b2 - c2) / b2
    q4 = (b2 - a2) / b2
    A4 = (q1 - 1.0) ** 2 - 4.0 * c2 / b2 * ca ** 2
    A3 = 4.0 * (q1 * (1.0 - q1) * cb - (1.0 - q2) * ca * cg
                + 2.0 * c2 / b2 * ca ** 2 * cb)
    A2 = 2.0 * (q1 ** 2 - 1.0 + 2.0 * q1 ** 2 * cb ** 2 + 2.0 * q3 * ca ** 2
                - 4.0 * q2 * ca * cb * cg + 2.0 * q4 * cg ** 2)
    A1 = 4.0 * (-q1 * (1.0 + q1) * cb + 2.0 * a2 / b2 * cg ** 2 * cb
                - (1.0 - q2) * ca * cg)
    A0 = (1.0 + q1) ** 2 - 4.0 * a2 / b2 * cg ** 2

    v = quartic_roots(torch.stack([A4, A3, A2, A1, A0], dim=-1))    # (...,4) = s3/s1
    a2, b2, c2, ca, cb, cg = (x[..., None] for x in (a2, b2, c2, ca, cb, cg))

    # s1 from the 1-3 law of cosines, u = s2/s1 from the 1-2 equation (two
    # roots), picked by the 2-3 equation's residual
    s1sq = b2 / torch.clamp(1.0 + v * v - 2.0 * v * cb, min=_EPS)
    s1 = torch.sqrt(s1sq)
    rad = torch.sqrt(torch.clamp(cg * cg - 1.0 + c2 / s1sq, min=0.0))
    u_a, u_b = cg + rad, cg - rad

    def res_23(u):
        return torch.abs(s1sq * (u * u + v * v - 2.0 * u * v * ca) - a2)

    u = torch.where(res_23(u_a) <= res_23(u_b), u_a, u_b)
    s = torch.stack([s1, u * s1, v * s1], dim=-1)                    # (...,4,3) depths

    # Newton polish of the depths on the full law-of-cosines system
    eye = 1e-9 * torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(3):
        s1_, s2_, s3_ = s[..., 0], s[..., 1], s[..., 2]
        g = torch.stack([
            s2_ * s2_ + s3_ * s3_ - 2.0 * s2_ * s3_ * ca - a2,
            s1_ * s1_ + s3_ * s3_ - 2.0 * s1_ * s3_ * cb - b2,
            s1_ * s1_ + s2_ * s2_ - 2.0 * s1_ * s2_ * cg - c2,
        ], dim=-1)
        z = torch.zeros_like(s1_)
        J = 2.0 * torch.stack([
            torch.stack([z, s2_ - s3_ * ca, s3_ - s2_ * ca], dim=-1),
            torch.stack([s1_ - s3_ * cb, z, s3_ - s1_ * cb], dim=-1),
            torch.stack([s1_ - s2_ * cg, s2_ - s1_ * cg, z], dim=-1),
        ], dim=-2)                                                   # (...,4,3,3)
        delta = torch.linalg.solve_ex(J + eye, g[..., None])[0][..., 0]
        s_new = s - delta
        s = torch.where(torch.isfinite(s_new), s_new, s)

    Y = s[..., None] * f[..., None, :, :]                          # (...,4,3,3) cam points
    V = _frame(X0, X1, X2)[..., None, :, :]
    U = _frame(Y[..., 0, :], Y[..., 1, :], Y[..., 2, :])
    R = U @ V.transpose(-1, -2)
    t = torch.mean(Y, dim=-2) - (R @ torch.mean(X, dim=-2)[..., None, :, None])[..., 0]
    return R, t
