"""Every public top-level function and class of ``sfmx`` has a counterpart in
``sfmx_torch``: the same name in the module at the same path, or an entry of
the two lists below.  Both packages are read with ``ast``; neither is
imported.

RENAMED maps a reference module or name to the port's own.  EXCLUDED lists
what the port does not carry, each with the reason that ROADMAP.md's "Do not
port" list gives."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "sfmx", ROOT / "sfmx_torch"

# the Pallas modules' ports are named for what they compute
MODULES = {
    "kernels/pallas_scale_space.py": "kernels/scale_space.py",
    "kernels/pallas_describe.py": "kernels/describe.py",
    "kernels/pallas_match.py": "kernels/match.py",
    "kernels/pallas_pairs.py": "kernels/pairs.py",
    "kernels/pallas_tiles.py": "kernels/tiles.py",
}

# (reference module, name) -> the port's name in the mapped module
RENAMED = {
    ("kernels/segsum.py", "schur_cross_matvec_ref"): "schur_cross_matvec_plain",
    ("kernels/pallas_pairs.py", "match_pairs_float_pallas"): "match_pairs_fused",
    # K2 computes every level in one launch
    ("kernels/pallas_scale_space.py", "response_level"): "response_levels",
    # K7 assembles and reduces in one pass, so reduction is named for the fusion
    ("solvers/schur.py", "reduce_system_dense"): "reduce_system_fused",
}

_BLOCKS = ("the (O,2,6) block Schur pipeline, which recomputes what the planes pipeline "
           "holds")
_ROWS = ("the SegmentRows path (lm.ba_solve tp_cap/tc_cap without dense_cg), a TPU-raced "
         "alternative kept to re-race")
_TRACKS = "no caller in the repo"
_MESH = "the JAX mesh API; the port's process groups (dist/mesh.py) do its work"

EXCLUDED = {
    ("solvers/schur.py", "NormalBlocks"): _BLOCKS,
    ("solvers/schur.py", "assemble"): _BLOCKS,
    ("solvers/schur.py", "SchurSystem"): _BLOCKS,
    ("solvers/schur.py", "reduce_system"): _BLOCKS,
    ("solvers/schur.py", "schur_matvec"): _BLOCKS,
    ("solvers/schur.py", "solve_points"): _BLOCKS,
    ("solvers/schur.py", "pcg"): _BLOCKS,
    ("solvers/schur.py", "SegmentRows"): _ROWS,
    ("solvers/schur.py", "build_rows"): _ROWS,
    ("solvers/schur.py", "rows_sum"): _ROWS,
    ("solvers/schur.py", "TrackBlocks"): _TRACKS,
    ("solvers/schur.py", "build_track_blocks_static"): _TRACKS,
    ("solvers/schur.py", "with_coupling"): _TRACKS,
    ("solvers/schur.py", "schur_matvec_blocked"): _TRACKS,
    # a TPU layout workaround: the cam_window VMEM fence of the one-hot camera windows
    ("kernels/segsum.py", "compute_cam_window"): "a VMEM fence (TPU layout workaround)",
    ("dist/mesh.py", "make_mesh"): _MESH,
    ("dist/mesh.py", "make_mesh_2d"): _MESH,
    ("dist/mesh.py", "shard_along"): _MESH,
    ("dist/mesh.py", "replicated"): _MESH,
}

# the functions the port took in last; each one's absence must fail the check
LAST_PORTED = [
    ("core/se3.py", n) for n in ("vee", "so3_log", "rot_to_quat", "quat_to_rot", "se3_exp",
                                 "se3_log", "project_to_so3")
] + [("core/cameras.py", n) for n in ("make_intrinsics", "bearing", "K_matrix")] + [
    ("core/masking.py", n) for n in ("masked_argmin", "pad_axis_to", "first_free_slot", "count",
                                     "scatter_set")
] + [("kernels/features.py", "scharr")]


def public_defs(path: Path) -> list[str]:
    """The public top-level ``def``/``class`` names of a module."""
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def bound_names(path: Path) -> set[str]:
    """Every name a module binds at top level by ``def``, ``class`` or
    assignment (an alias such as ``so3_exp_b = so3_exp`` counts)."""
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                names.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
    return names


def missing(rel: str, port_names: set[str]) -> list[str]:
    """The reference module's public names with no counterpart among
    ``port_names`` and on neither list."""
    out = []
    for name in public_defs(REF / rel):
        if (rel, name) in EXCLUDED:
            continue
        if RENAMED.get((rel, name), name) not in port_names:
            out.append(name)
    return out


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def test_the_reference_has_its_modules():
    assert len(REF_MODULES) >= 50
    assert all(public_defs(REF / rel) is not None for rel in REF_MODULES)


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_function_has_a_counterpart(rel):
    port = PORT / MODULES.get(rel, rel)
    assert port.exists(), f"sfmx/{rel} has no counterpart sfmx_torch/{MODULES.get(rel, rel)}"
    gone = missing(rel, bound_names(port))
    assert not gone, f"sfmx/{rel}: no counterpart in sfmx_torch/{MODULES.get(rel, rel)} for {gone}"


def test_the_lists_name_what_exists():
    """Every renamed or excluded entry names a public function of the
    reference; every rename's target exists in the port; no excluded name
    exists in the port (it would then be ported, not excluded); every
    exclusion gives a reason."""
    for (rel, name), target in RENAMED.items():
        assert name in public_defs(REF / rel), (rel, name)
        assert target in bound_names(PORT / MODULES.get(rel, rel)), (rel, target)
    for (rel, name), why in EXCLUDED.items():
        assert name in public_defs(REF / rel), (rel, name)
        assert name not in bound_names(PORT / MODULES.get(rel, rel)), (rel, name)
        assert why.strip(), (rel, name)
    for rel in MODULES:
        assert (REF / rel).exists() and not (PORT / rel).exists(), rel


@pytest.mark.parametrize("rel,name", LAST_PORTED, ids=[n for _, n in LAST_PORTED])
def test_the_check_fails_without_each_last_ported_function(rel, name):
    """Take one of the last ported functions out of the port's names: the
    check reports exactly that function."""
    names = bound_names(PORT / rel)
    assert name in names
    assert missing(rel, names) == []
    assert missing(rel, names - {name}) == [name]
