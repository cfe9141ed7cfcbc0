"""sfmx_torch core parity: se3, cameras, masking, linalg — the same numpy
inputs through ``sfmx`` (JAX on CPU) and its PyTorch port."""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfmx.core import cameras as jcam
from sfmx.core import masking as jmask
from sfmx.core import se3 as jse3
from sfmx.solvers import linalg as jlinalg
from sfmx_torch.core import cameras as tcam
from sfmx_torch.core import masking as tmask
from sfmx_torch.core import se3 as tse3
from sfmx_torch.solvers import linalg as tlinalg

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


def _rotvecs(rng, n=32):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)
            * rng.uniform(0.0, 3.0, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-5, 0.0])
def test_so3_exp_matches_reference(rng, scale):
    """Rodrigues and its Taylor branch (tiny and zero angles); atol 1e-6."""
    w = _rotvecs(rng) * np.float32(scale)
    ref = np.asarray(jse3.so3_exp_b(jnp.asarray(w)))
    np.testing.assert_allclose(tse3.so3_exp(T(w)).numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(tse3.hat(T(w)).numpy(),
                               np.asarray(jax.vmap(jse3.hat)(jnp.asarray(w))), atol=0)


def test_perturb_matches_reference(rng):
    R = np.asarray(jse3.so3_exp_b(jnp.asarray(_rotvecs(rng, 8))))
    t = rng.normal(size=(8, 3)).astype(np.float32)
    d = (0.1 * rng.normal(size=(8, 6))).astype(np.float32)
    Rr, tr = jse3.perturb_b(jnp.asarray(R), jnp.asarray(t), jnp.asarray(d))
    Rp, tp = tse3.perturb(T(R), T(t), T(d))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), atol=1e-6)


def test_project_to_so3_fast_matches_reference(rng):
    """Scaled, noisy and reflected rotations; atol 1e-5 (f32 polar iteration)."""
    R = np.asarray(jse3.so3_exp_b(jnp.asarray(_rotvecs(rng, 16))))
    M = (R * rng.uniform(0.2, 3.0, (16, 1, 1))
         + 0.05 * rng.normal(size=(16, 3, 3))).astype(np.float32)
    M[::3] *= -1.0
    ref = np.asarray(jax.vmap(jse3.project_to_so3_fast)(jnp.asarray(M)))
    out = tse3.project_to_so3_fast(T(M)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(out), 1.0, atol=1e-5)


def test_project_to_so3_fast_degenerate_gives_identity():
    out = tse3.project_to_so3_fast(torch.full((2, 3, 3), float("nan")))
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)))


def test_cameras_match_reference(rng):
    """pixel_to_normalized (8 undistortion iterations) and project; atol 1e-5."""
    k = np.array([500.0, 480.0, 320.0, 240.0, -0.2, 0.05, 0.01], np.float32)
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    ref = np.asarray(jcam.pixel_to_normalized(jnp.asarray(k), jnp.asarray(uv)))
    np.testing.assert_allclose(tcam.pixel_to_normalized(T(k), T(uv)).numpy(), ref, atol=1e-6)
    xd = rng.uniform(-0.5, 0.5, (50, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.undistort_radial(T(k), T(xd)).numpy(),
        np.asarray(jcam.undistort_radial(jnp.asarray(k), jnp.asarray(xd))), atol=1e-6)
    R = np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(rng, 1)[0] * 0.2)))
    t = np.array([0.1, -0.2, 4.0], np.float32)
    X = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    uv_r, z_r = jcam.project(jnp.asarray(k), jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))
    uv_p, z_p = tcam.project(T(k), T(R), T(t), T(X))
    np.testing.assert_allclose(uv_p.numpy(), np.asarray(uv_r), atol=1e-3)  # pixels
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_r), atol=1e-6)


def test_topk_lowest_index_ties_match_lax_top_k(rng):
    """Tied values come out lowest index first, as lax.top_k orders them."""
    x = rng.integers(0, 4, (6, 40)).astype(np.float32)
    x[0] = 1.0                                   # all tied
    x[1, ::2] = -np.inf
    vals, idx = jax.lax.top_k(jnp.asarray(x), 12)
    tv, ti = tmask.topk_lowest_index(T(x), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


def test_masked_helpers_match_reference(rng):
    s = rng.normal(size=(4, 20)).astype(np.float32)
    m = rng.random((4, 20)) > 0.4
    m[2] = False
    rv, ri, rok = jmask.masked_top_k(jnp.asarray(s), jnp.asarray(m), 5)
    tv, ti, tok = tmask.masked_top_k(T(s), T(m), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(rok))
    av, ai, aok = jmask.masked_argmax(jnp.asarray(s), jnp.asarray(m))
    bv, bi, bok = tmask.masked_argmax(T(s), T(m))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ai))
    np.testing.assert_array_equal(bok.numpy(), np.asarray(aok))
    np.testing.assert_allclose(tmask.masked_mean(T(s), T(m), dim=1).numpy(),
                               np.asarray(jmask.masked_mean(jnp.asarray(s), jnp.asarray(m), axis=1)),
                               atol=1e-6)


def test_smallest_eigvec_matches_reference(rng):
    """Well-conditioned 12x12 SPD: the same vector up to sign; atol 1e-4."""
    A = rng.normal(size=(8, 20, 12)).astype(np.float32)
    AtA = np.einsum("bni,bnj->bij", A, A)
    ref = np.asarray(jax.vmap(lambda a: jlinalg.smallest_eigvec_spd(a, exact_fallback=False))(
        jnp.asarray(AtA)))
    out = tlinalg.smallest_eigvec_spd(T(AtA)).numpy()
    sign = np.sign(np.sum(out * ref, axis=1, keepdims=True))
    np.testing.assert_allclose(out * sign, ref, atol=1e-4)


def test_cholesky_breakdown_returns_start_vector_without_raising():
    """Indefinite or NaN matrices: cholesky_ex reports the breakdown and the
    batch goes on; the broken rows return v0, as the reference's NaN check
    does, and the healthy row in the same batch is unaffected."""
    good = np.diag(np.array([400.0, 300.0, 200.0, 1.0], np.float32))
    indefinite = np.diag(np.array([1.0, -2.0, 3.0, 4.0], np.float32))
    nan = np.full((4, 4), np.nan, np.float32)
    A = np.stack([good, indefinite, nan])
    v = tlinalg.smallest_eigvec_spd(T(A)).numpy()
    v0 = np.full(4, 0.5, np.float32)
    np.testing.assert_allclose(np.abs(v[0]), [0, 0, 0, 1], atol=1e-5)
    np.testing.assert_array_equal(v[1], v0)
    np.testing.assert_array_equal(v[2], v0)
    ref = np.asarray(jax.vmap(lambda a: jlinalg.smallest_eigvec_spd(a, exact_fallback=False))(
        jnp.asarray(A)))
    np.testing.assert_array_equal(ref[1:], v[1:])
    # a batch of only broken matrices: every row v0, nothing raised
    vb = tlinalg.smallest_eigvec_spd(T(np.stack([indefinite, nan] * 3))).numpy()
    np.testing.assert_array_equal(vb, np.broadcast_to(v0, vb.shape))


def test_port_imports_without_jax_or_sfmx():
    """Every sfmx_torch module imports with jax and sfmx blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in list(sys.modules):
            if name == "jax" or name.startswith(("jax.", "jaxlib", "sfmx.")) or name == "sfmx":
                del sys.modules[name]
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        sys.modules["sfmx"] = None
        import sfmx_torch
        names = [m.name for m in pkgutil.walk_packages(sfmx_torch.__path__, "sfmx_torch.")]
        for n in names:
            importlib.import_module(n)
        import torch
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
