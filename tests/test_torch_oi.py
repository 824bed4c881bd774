"""The port's OI pieces against gridpp_tpu's, on the same inputs.

Selection is discrete and must agree exactly (the stable top-S: the lower
slot wins a tie, as jax.lax.top_k does). The solve and the tiled functions
are f32 arithmetic in the same order; bars rtol 1e-5 / atol 1e-5 for the
solve and 1e-4 for the tiled functions fed gridpp_tpu's own geometry.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import gj, gt, obs_values, objects, problem, tensor  # noqa: E402,E501

from gridpp_tpu.ops import oi as joi  # noqa: E402
from gridpp_tpu.ops import oi_tiled as jtiled  # noqa: E402
from gridpp_tpu_torch.ops import oi as toi  # noqa: E402
from gridpp_tpu_torch.ops import oi_tiled as ttiled  # noqa: E402

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_top_ties_match_top_k(seed):
    rng = np.random.default_rng(seed)
    rho = rng.choice(np.float32([0.1, 0.5, 0.5, 0.9]), (300, 20))
    valid = rng.random((300, 20)) < 0.7
    valid[:5] = False  # rows with no valid candidate: -inf ties
    vj, sj, okj = joi._select_top(jnp.asarray(rho), jnp.asarray(valid), 10)
    vt, st, okt = toi._select_top(tensor(rho), tensor(valid), 10)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))


def _system(seed, b=200, s=8):
    """SPD OI systems: Barnes correlations of random points + a ridge,
    with some slots invalid (identity rows)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 20000, (b, s, 3)).astype(np.float32)
    d = np.linalg.norm(pos[:, :, None] - pos[:, None], axis=-1)
    a = np.exp(-0.5 * (d / 30000.0) ** 2).astype(np.float32)
    valid = rng.random((b, s)) < 0.8
    pair = valid[:, :, None] & valid[:, None, :]
    eye = np.eye(s, dtype=np.float32)
    a = np.where(pair, a, 0) + eye * np.where(valid, 0.2, 1.0)[:, None, :]
    a = np.where(pair | (eye > 0), a, 0).astype(np.float32)
    rhs = np.where(valid, rng.uniform(0, 1, (b, s)), 0).astype(np.float32)
    return a, rhs


@pytest.mark.parametrize("seed", [0, 1])
def test_gj_solve_matches(seed):
    a, rhs = _system(seed)
    want = np.asarray(joi._gj_solve_batch_last(
        jnp.asarray(a.transpose(1, 2, 0)), jnp.asarray(rhs.T))).T
    got = toi._gj_solve(tensor(a), tensor(rhs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("allow", [True, False])
def test_solve_selected_matches(allow):
    rng = np.random.default_rng(4)
    b, s = 300, 10
    fields = {"x": rng.normal(0, 20000, (b, s)), "y": rng.normal(0, 20000,
                                                                 (b, s)),
              "z": rng.normal(0, 2000, (b, s)),
              "elev": rng.uniform(0, 300, (b, s)),
              "laf": rng.uniform(0, 1, (b, s))}
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    valid = rng.random((b, s)) < 0.8
    lg = np.where(valid, rng.uniform(0.05, 1, (b, s)), 0).astype(np.float32)
    l_obs = rng.normal(280, 3, (b, s)).astype(np.float32)
    l_y = rng.normal(280, 3, (b, s)).astype(np.float32)
    l_r = np.full((b, s), 0.3, np.float32)
    bg = rng.normal(280, 3, b).astype(np.float32)
    bg[::17] = np.nan
    bv = np.ones(b, np.float32)
    args = (lg, valid, l_obs, l_y, l_r, bg, bv)
    sj = gj.BarnesStructure(30000.0, 200.0, 0.5)
    st = gt.BarnesStructure(30000.0, 200.0, 0.5)
    oj, aj = joi._solve_selected(
        sj, {k: jnp.asarray(v) for k, v in fields.items()},
        *[jnp.asarray(v) for v in args], allow)
    ot, at = toi._solve_selected(
        st, {k: tensor(v) for k, v in fields.items()},
        *[tensor(v) for v in args], allow)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def tiled_pair():
    """A gridpp_tpu tiled Pipeline and a port Pipeline holding its
    geometry and static weights through load_state."""
    prob = problem(1, n=40, n_obs=80, elevs=True)
    grid, pts, _ = objects(gj, prob)
    sj = gj.BarnesStructure(30000.0, 200.0, 0.5)
    pj = gj.Pipeline(grid, pts, sj, max_points=6, tiled=True,
                     tile_shape=(8, 16), ratios=prob["ratios"])
    g2, p2, _ = objects(gt, prob)
    st = gt.BarnesStructure(30000.0, 200.0, 0.5)
    pt = gt.Pipeline(g2, p2, st, max_points=6, tiled=True,
                     tile_shape=(8, 16), ratios=prob["ratios"], device="cpu")
    geom = pj._geom
    state = {k: np.asarray(v) for k, v in pj._geom_dev.items()}
    state["static_keys"] = list(geom.static_keys)
    state.update({k: np.asarray(v) for k, v in pj._static_w.items()})
    pt.load_state(state)
    return prob, grid, pj, pt


def _compare_weights(wt, wj, with_a=True):
    vs = np.asarray(wj["valid_s"])
    np.testing.assert_array_equal(wt["valid_s"].numpy(), vs)
    np.testing.assert_array_equal(wt["local_s"].numpy()[vs],
                                  np.asarray(wj["local_s"])[vs])
    np.testing.assert_allclose(wt["weights"].numpy(),
                               np.asarray(wj["weights"]), atol=1e-4)
    if with_a:
        np.testing.assert_allclose(wt["a_scalar"].numpy(),
                                   np.asarray(wj["a_scalar"]), atol=1e-4)


def test_loaded_state_round_trips(tiled_pair):
    _, _, pj, pt = tiled_pair
    state = pt.state()
    for key, v in pj._geom_dev.items():
        np.testing.assert_array_equal(state[key], np.asarray(v))
    for key, v in pj._static_w.items():
        np.testing.assert_array_equal(state[key], np.asarray(v))


def test_tile_untile(tiled_pair):
    prob, _, pj, pt = tiled_pair
    bg = prob["background"]
    tj = np.asarray(jtiled.tile_fields(jnp.asarray(bg), pj._geom))
    tt = ttiled.tile_fields(tensor(bg), pt._geom)
    np.testing.assert_array_equal(tt.numpy(), tj)
    np.testing.assert_array_equal(ttiled.untile_fields(tt, pt._geom).numpy(),
                                  bg)


def test_build_static_weights(tiled_pair):
    prob, _, pj, pt = tiled_pair
    wj = jtiled.build_static_weights(
        pj.structure, pj._geom_dev, tuple(pj._geom.static_keys),
        jnp.asarray(prob["ratios"]), 6)
    wt = ttiled.build_static_weights(
        pt.structure, pt._geom_dev, pt._static_keys,
        tensor(prob["ratios"]), 6)
    _compare_weights(wt, wj)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_weights_dynamic(tiled_pair, seed):
    prob, _, pj, pt = tiled_pair
    rng = np.random.default_rng(seed)
    ratios = rng.uniform(0.05, 0.5, prob["ratios"].size).astype(np.float32)
    valid = (rng.random(ratios.size) < 0.7).astype(np.float32)
    wj = jtiled.build_weights_dynamic(
        pj.structure, pj._geom_dev, tuple(pj._geom.static_keys),
        jnp.asarray(ratios), jnp.asarray(valid), 6)
    wt = ttiled.build_weights_dynamic(
        pt.structure, pt._geom_dev, pt._static_keys, tensor(ratios),
        tensor(valid), 6)
    _compare_weights(wt, wj, with_a=False)


@pytest.mark.parametrize("allow", [True, False])
def test_apply_weights(tiled_pair, allow):
    prob, grid, pj, pt = tiled_pair
    pback, pobs = obs_values(prob, grid)
    innov = np.where(np.isfinite(pobs), pobs - pback, 0).astype(np.float32)
    bg = prob["background"]
    out_j = jtiled.oi_tiled_apply_weights(
        pj._static_w, pj._geom_dev["tile_table"],
        jtiled.tile_fields(jnp.asarray(bg), pj._geom), jnp.asarray(innov),
        allow)
    out_t = ttiled.oi_tiled_apply_weights(
        pt._static_w, pt._geom_dev["tile_table"],
        ttiled.tile_fields(tensor(bg), pt._geom), tensor(innov), allow)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-4)


@pytest.mark.parametrize("allow", [True, False])
def test_sweep(tiled_pair, allow):
    prob, grid, pj, pt = tiled_pair
    pback, pobs = obs_values(prob, grid)
    ok = np.isfinite(pobs) & np.isfinite(pback)
    packed = np.stack([np.where(ok, pobs, 0), np.where(ok, pback, 0),
                       prob["ratios"], ok], axis=1).astype(np.float32)
    bg = prob["background"].copy()
    bg[::7, ::5] = np.nan
    bg_tj = jtiled.tile_fields(jnp.asarray(bg), pj._geom)
    bv = np.full(bg_tj.shape, 2.0, np.float32)
    oj, vj = jtiled.oi_tiled_sweep(
        pj.structure, pj._geom_dev, tuple(pj._geom.static_keys), bg_tj,
        jnp.asarray(bv), jnp.asarray(packed), 6, allow)
    ot, vt = ttiled.oi_tiled_sweep(
        pt.structure, pt._geom_dev, pt._static_keys,
        ttiled.tile_fields(tensor(bg), pt._geom), tensor(bv),
        tensor(packed), 6, allow)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_oi_block_from_candidates():
    prob = problem(2, n=20, n_obs=40)
    grid, pts, sj = objects(gj, prob)
    g2, p2, st = objects(gt, prob)
    pback, pobs = obs_values(prob, grid)
    from gridpp_tpu.api.oi import _origin, _resolved_fields
    from gridpp_tpu.ops.canonical import canonical_shortlist
    bpts = grid.to_points()
    sl = canonical_shortlist(bpts, pts, sj, 12)
    fields = _resolved_fields(pts, sj, _origin(bpts))
    bg = prob["background"].reshape(-1)
    args = (sl.sel, sl.rho, sl.valid)
    vals = (bg, np.ones_like(bg), pobs, pback, prob["ratios"])
    oj, _ = joi.oi_block_from_candidates(
        sj, *[jnp.asarray(a) for a in args],
        {k: jnp.asarray(v) for k, v in fields.items()},
        *[jnp.asarray(v) for v in vals], 8, True)
    ot, _ = toi.oi_block_from_candidates(
        st, *[tensor(a) for a in args],
        {k: tensor(v) for k, v in fields.items()},
        *[tensor(v) for v in vals], 8, True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-4)
