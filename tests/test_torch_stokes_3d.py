"""The Stokes problem in 3D (the <2,3> instantiation: a sphere of radius 0.1
in the unit cube) at 3:0, the smallest pairing of the results table that
keeps h_Γ/h in the reference's 1.3-2.3 band and leaves the GMG two levels,
with the table's configuration but an outer tolerance of 1e-6, in both
packages: see ``test_torch_stokes.py``."""

from test_torch_stokes import DIAG_W, check_solve, config_3d, \
    reference_solve
from fictitious_domain_al_preconditioners_torch.ops.sparse_band import (
    MAX_PLANES, band_plane_keys_lower_bound)


def sphere(mod):
    cfg = config_3d(mod, initial_refinement=3, initial_embedded_refinement=0)
    cfg.outer.tolerance, cfg.outer.reduction = 1e-6, 1e-12
    return cfg


def test_3d_matches_reference():
    tp = check_solve(reference_solve(sphere), sphere)
    assert tp.results["dofs_background"] == 3 * 17 ** 3 + 9 ** 3
    assert tp.results["dofs_immersed"] == 3 * 8
    assert tp.results["outer_iterations"] >= 5
    # Q2 in 3D couples 125 lattice offsets in each of 9 component pairs: no
    # level is a band stencil
    local = tp._vel_local(tp.vel_space)
    keys = band_plane_keys_lower_bound(tp.vel_space.fe, local, 3)
    assert len(keys) == 9 * 125
    assert 9 * 125 > MAX_PLANES
    assert tp.results["gmg_routes"] == ["element", "element"]
