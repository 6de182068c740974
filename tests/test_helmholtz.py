"""Helmholtz solver tests: DST round-trip, residual of the discrete
operator, and equivalence with the reference's FFT+Thomas formulation
(via the retained thomas_solve)."""

import jax.numpy as jnp
import numpy as np
import pytest

from qgcm_tpu.solver.helmholtz import (
    dst1, make_box_helmholtz, make_cyclic_helmholtz, thomas_solve)


def test_dst1_round_trip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 31))
    n = x.shape[-1]
    out = dst1(dst1(jnp.asarray(x), axis=-1), axis=-1)
    np.testing.assert_allclose(np.asarray(out), 2 * (n + 1) * x, rtol=1e-12)


def test_dst1_matches_direct():
    rng = np.random.default_rng(1)
    n = 13
    x = rng.standard_normal(n)
    j = np.arange(1, n + 1)
    k = np.arange(1, n + 1)
    direct = 2 * np.sin(np.pi * np.outer(k, j) / (n + 1)) @ x
    out = np.asarray(dst1(jnp.asarray(x)))
    np.testing.assert_allclose(out, direct, rtol=1e-11, atol=1e-12)


def _residual_box(sol, rhs, dx, dy, rdm2):
    """5-point del^2 sol - rdm2*sol on the interior, minus rhs."""
    lap = (sol[..., 1:-1, :-2] + sol[..., 1:-1, 2:]) / dx**2 \
        + (sol[..., :-2, 1:-1] + sol[..., 2:, 1:-1]) / dy**2 \
        - 2.0 * (1.0 / dx**2 + 1.0 / dy**2) * sol[..., 1:-1, 1:-1]
    return lap - rdm2[:, None, None] * sol[..., 1:-1, 1:-1] \
        - rhs[..., 1:-1, 1:-1]


def test_box_solver_residual():
    rng = np.random.default_rng(2)
    nxp, nyp = 33, 25
    dx, dy = 5e3, 5e3
    rdm2 = np.array([0.0, 1.0 / 40e3**2, 1.0 / 20e3**2])
    solver = make_box_helmholtz(nxp, nyp, dx, dy, rdm2)
    rhs = rng.standard_normal((3, nyp, nxp)) * 1e-9
    sol = np.asarray(solver.solve(jnp.asarray(rhs)))
    # Dirichlet boundaries
    assert np.all(sol[:, 0, :] == 0) and np.all(sol[:, -1, :] == 0)
    assert np.all(sol[:, :, 0] == 0) and np.all(sol[:, :, -1] == 0)
    res = _residual_box(sol, rhs, dx, dy, rdm2)
    assert np.max(np.abs(res)) < 1e-9 * np.max(np.abs(rhs))


def test_cyclic_solver_residual():
    rng = np.random.default_rng(3)
    nxp, nyp = 33, 25   # nx = 32 columns distinct
    dx, dy = 5e3, 5e3
    rdm2 = np.array([0.0, 1.0 / 40e3**2])
    solver = make_cyclic_helmholtz(nxp, nyp, dx, dy, rdm2)
    rhs = rng.standard_normal((2, nyp, nxp)) * 1e-9
    rhs[..., -1] = rhs[..., 0]
    sol = np.asarray(solver.solve(jnp.asarray(rhs)))
    assert np.allclose(sol[..., -1], sol[..., 0])
    assert np.all(sol[:, 0, :] == 0) and np.all(sol[:, -1, :] == 0)
    # residual on interior incl. wrapped columns
    ext = np.concatenate([sol[..., -2:-1], sol], axis=-1)  # west ghost
    lap = (ext[..., 1:-1, :-2] + ext[..., 1:-1, 2:]) / dx**2 \
        + (ext[..., :-2, 1:-1] + ext[..., 2:, 1:-1]) / dy**2 \
        - 2.0 * (1 / dx**2 + 1 / dy**2) * ext[..., 1:-1, 1:-1]
    res = lap - rdm2[:, None, None] * sol[:, 1:-1, :-1] \
        - rhs[:, 1:-1, :-1]
    assert np.max(np.abs(res)) < 1e-9 * np.max(np.abs(rhs))


def test_spectral_matches_thomas():
    """The 2-D spectral solve must reproduce the reference's
    x-transform + y-tridiagonal algorithm to roundoff."""
    rng = np.random.default_rng(4)
    nxp, nyp = 17, 21
    nx = nxp - 1
    dx = dy = 4e3
    rdm2 = np.array([1.0 / 30e3**2])
    solver = make_box_helmholtz(nxp, nyp, dx, dy, rdm2)
    rhs = rng.standard_normal((1, nyp, nxp)) * 1e-9
    sol = np.asarray(solver.solve(jnp.asarray(rhs)))

    # reference algorithm: DST in x, Thomas in y, inverse DST
    aoc = 1.0 / dy**2
    k = np.arange(1, nx)
    bd2 = -2.0 * aoc + 2.0 / dx**2 * (np.cos(np.pi * k / nx) - 1.0)
    spec_x = np.asarray(dst1(jnp.asarray(rhs[0, 1:-1, 1:-1]), axis=-1))
    diag = jnp.asarray(bd2 - rdm2[0])
    tsol = np.asarray(thomas_solve(diag, aoc, jnp.asarray(spec_x)))
    back = np.asarray(dst1(jnp.asarray(tsol), axis=-1)) / (2 * nx)
    np.testing.assert_allclose(sol[0, 1:-1, 1:-1], back,
                               rtol=1e-10, atol=1e-22)


def test_matmul_transform_matches_fft():
    """The sine-matrix DST backend (transform='matmul') must solve
    the same problem as the FFT backend: identical solution to
    roundoff, and the same residual exactness. On CPU f64 the two are
    equal to ~1e-12 (chip_smoke.py phase c holds both float32 backends
    to 2e-6 of a float64 solve on the GPU)."""
    rng = np.random.default_rng(7)
    nxp, nyp = 37, 29
    dx, dy = 5e3, 5e3
    rdm2 = np.array([0.0, 2.3e-9, 8.1e-9])
    rhs = np.zeros((3, nyp, nxp))
    rhs[:, 1:-1, 1:-1] = rng.standard_normal((3, nyp - 2, nxp - 2))

    fft = make_box_helmholtz(nxp, nyp, dx, dy, rdm2, transform="fft")
    mm = make_box_helmholtz(nxp, nyp, dx, dy, rdm2,
                            transform="matmul")
    a = np.asarray(fft.solve(jnp.asarray(rhs)))
    b = np.asarray(mm.solve(jnp.asarray(rhs)))
    scale = np.abs(a).max()
    assert np.abs(a - b).max() < 1e-11 * scale
    res = _residual_box(b, rhs, dx, dy, rdm2)
    assert np.abs(res).max() < 1e-7 * np.abs(rhs).max()

    # forward/inverse pair consistency (used by the box constraint
    # path: solve_spec + spectral corrections + inverse)
    sf = np.asarray(fft.forward(jnp.asarray(rhs)))
    sm = np.asarray(mm.forward(jnp.asarray(rhs)))
    assert np.abs(sf - sm).max() < 1e-10 * np.abs(sf).max()


def test_matmul_radix_split(monkeypatch):
    """The even/odd radix-2 split inside _dst1_mm (taken only above
    _MM_SPLIT_MIN in production) must reproduce the plain DST-I at
    every odd size, through multiple recursion levels, on both the
    last and the second-to-last axis."""
    import qgcm_tpu.solver.helmholtz as H
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    rng = np.random.default_rng(3)
    for n in (7, 31, 35, 64, 101, 255):
        x = rng.standard_normal((2, n, 5))
        for axis in (-1, -2):
            xa = jnp.asarray(np.swapaxes(x, axis, -1)
                             if axis == -1 else x)
            a = np.asarray(dst1(xa, axis=axis))
            b = np.asarray(H._dst1_mm(xa, axis))
            assert np.abs(a - b).max() < 1e-13 * np.abs(a).max(), \
                (n, axis)


def test_matmul_packed_solver(monkeypatch):
    """With the split active, the matmul solver keeps spectra in
    packed order with permuted eigenvalue/weight vectors. The full
    solve, the Parseval contraction used by the mass constraint, and
    the rank-one homogeneous correction must all match the FFT
    backend to roundoff through multiple recursion levels."""
    import qgcm_tpu.solver.helmholtz as H
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    rng = np.random.default_rng(11)
    for nxp, nyp in ((37, 29), (38, 36), (48, 37)):
        dx, dy = 5e3, 7e3
        rdm2 = np.array([0.0, 2.3e-9, 8.1e-9])
        rhs = np.zeros((3, nyp, nxp))
        rhs[:, 1:-1, 1:-1] = rng.standard_normal((3, nyp - 2, nxp - 2))
        fft = make_box_helmholtz(nxp, nyp, dx, dy, rdm2,
                                 transform="fft")
        mm = make_box_helmholtz(nxp, nyp, dx, dy, rdm2,
                                transform="matmul")
        a = np.asarray(fft.solve(jnp.asarray(rhs)))
        b = np.asarray(mm.solve(jnp.asarray(rhs)))
        assert np.abs(a - b).max() < 1e-11 * np.abs(a).max(), (nxp, nyp)

        # permutation-invariant Parseval contraction (mass constraint)
        sf = np.asarray(fft.forward(jnp.asarray(rhs)))
        sm = np.asarray(mm.forward(jnp.asarray(rhs)))
        cf = np.einsum("myx,y,x->m", sf, np.asarray(fft.gy),
                       np.asarray(fft.gx))
        cm = np.einsum("myx,y,x->m", sm, np.asarray(mm.gy),
                       np.asarray(mm.gx))
        np.testing.assert_allclose(cm, cf, rtol=1e-10)

        # rank-one spectral correction + inverse (homogeneous path)
        def corr(h, s):
            gyx = np.asarray(h.gy)[None, :, None] \
                * np.asarray(h.gx)[None, None, :]
            den = (np.asarray(h.lamx)[None, None, :]
                   + np.asarray(h.lamy)[None, :, None]
                   - np.asarray(h.rdm2)[:, None, None])
            return np.asarray(h.inverse(jnp.asarray(s + gyx / den)))
        np.testing.assert_allclose(corr(mm, sm), corr(fft, sf),
                                   rtol=1e-9, atol=1e-20)


@pytest.mark.parametrize("dtype,dst", [
    ("float64", "fft"),
    ("float32", "fft"),
    ("float64", "matmul"),
    ("float32", "matmul"),
])
def test_dst_backend_wires_solvers(dtype, dst):
    """build_model puts every PV inversion on the FFT (the GPU sweep
    found no width where the matmul wins); with_dst moves all three
    solvers of a coupled model -- box ocean, channel ocean,
    atmosphere -- to the named backend."""
    from qgcm_tpu.config import double_gyre_coupled
    from qgcm_tpu.model import build_model, with_dst

    box = double_gyre_coupled(nxta=24, nyta=12, nxaooc=8, nyaooc=8,
                              ndxr=4, dtype=dtype)
    for cfg in (box, box.replace(cyclic_ocean=True, nxaooc=24)):
        model = build_model(cfg)
        helms = (model.inv_oc.helm, model.inv_at.helm)
        assert [getattr(h, "transform", None) or h.ytransform
                for h in helms] == ["fft", "fft"]
        moved = with_dst(model, dst)
        assert [getattr(h, "transform", None) or h.ytransform
                for h in (moved.inv_oc.helm, moved.inv_at.helm)] \
            == [dst, dst]
        assert moved.inv_oc.helm.lamy.dtype == np.dtype(dtype)


def test_with_dst_rejects_unknown_backend():
    """An unknown DST backend name fails at once, and asking for the
    backend the model already has returns the model itself."""
    from qgcm_tpu.config import double_gyre_coupled
    from qgcm_tpu.model import build_model, with_dst

    model = build_model(double_gyre_coupled(nxta=24, nyta=12, nxaooc=8,
                                            nyaooc=8, ndxr=4))
    assert with_dst(model, "fft") is model
    with pytest.raises(ValueError, match="dst must be one of"):
        with_dst(model, "high")


def test_cyclic_matmul_y_matches_fft(monkeypatch):
    """ytransform='matmul' (sine-kernel DST along y, packed split
    order with permuted lamy) must reproduce the FFT-y channel solve
    to roundoff through multiple recursion levels."""
    import qgcm_tpu.solver.helmholtz as H
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    rng = np.random.default_rng(13)
    for nxp, nyp in ((33, 30), (48, 37), (24, 66)):
        dx, dy = 5e3, 7e3
        rdm2 = np.array([0.0, 2.3e-9, 8.1e-9])
        rhs = np.zeros((3, nyp, nxp))
        rhs[:, 1:-1, :-1] = rng.standard_normal((3, nyp - 2, nxp - 1))
        rhs[:, :, -1] = rhs[:, :, 0]                # cyclic duplicate
        fft = make_cyclic_helmholtz(nxp, nyp, dx, dy, rdm2)
        mm = make_cyclic_helmholtz(nxp, nyp, dx, dy, rdm2,
                                   ytransform="matmul")
        a = np.asarray(fft.solve(jnp.asarray(rhs)))
        b = np.asarray(mm.solve(jnp.asarray(rhs)))
        assert np.abs(a - b).max() < 1e-11 * np.abs(a).max(), (nxp, nyp)


def test_block_spectra_match_packed(monkeypatch):
    """The tree-form block interface (forward_blocks/inverse_blocks)
    must reproduce the packed single-array transforms exactly:
    concatenated blocks == forward(), and inverse_blocks is its exact
    transpose, through multiple recursion levels."""
    import qgcm_tpu.solver.helmholtz as H
    monkeypatch.setattr(H, "_MM_SPLIT_MIN", 4)
    rng = np.random.default_rng(17)
    for nxp, nyp in ((37, 29), (48, 37)):
        dx, dy = 5e3, 7e3
        rdm2 = np.array([0.0, 2.3e-9, 8.1e-9])
        rhs = np.zeros((3, nyp, nxp))
        rhs[:, 1:-1, 1:-1] = rng.standard_normal((3, nyp - 2, nxp - 2))
        mm = make_box_helmholtz(nxp, nyp, dx, dy, rdm2,
                                transform="matmul")
        assert mm.supports_blocks
        xsizes, ysizes = mm.block_sizes()
        assert sum(xsizes) == nxp - 2 and sum(ysizes) == nyp - 2

        spec = mm.forward_blocks(jnp.asarray(rhs))
        cat = jnp.concatenate(
            [jnp.concatenate(sb, axis=-2) for sb in spec], axis=-1)
        ref = np.asarray(mm.forward(jnp.asarray(rhs)))
        assert np.abs(np.asarray(cat) - ref).max() \
            < 1e-12 * np.abs(ref).max()

        # inverse_blocks(forward_blocks(x)) * (2(N+1))^2 == interior x
        back = np.asarray(mm.inverse_blocks(spec))
        ref_back = np.asarray(mm.inverse(jnp.asarray(cat)))
        assert np.abs(back - ref_back).max() \
            < 1e-12 * np.abs(ref_back).max()
