"""The XLA route of the solver and the stereo matcher against plain NumPy
references: SGM scanline aggregation, one GN linearization (residuals,
IRLS weights, normal equations) built in float64, GN with cosine
interpolation, and the census planes."""
import jax.numpy as jnp
import numpy as np
import pytest

from bpvo_tpu.config import AlgorithmParameters
from bpvo_tpu.core import se3
from bpvo_tpu.data.stereo import _aggregate_4dir_scan, _aggregate_scanline
from bpvo_tpu.ops import census as census_ops
from bpvo_tpu.ops import descriptors
from bpvo_tpu.solver import gauss_newton as gn
from bpvo_tpu.types import DescriptorType, LossFunctionType
from bpvo_tpu.vo import template_data as td_mod
from bpvo_tpu.vo import warp as warp_mod
from conftest import synthetic_image


# ---------------------------------------------------------------------------
# SGM aggregation
# ---------------------------------------------------------------------------

def naive_scanline(cost, p1, p2):
    """The SGM recurrence along axis 0 of (T, B, D), one step at a time."""
    out = np.zeros_like(cost)
    out[0] = cost[0]
    for t in range(1, cost.shape[0]):
        prev = out[t - 1]
        m = prev.min(-1, keepdims=True)
        up = np.concatenate([prev[:, :1] + p1, prev[:, :-1] + p1], -1)
        dn = np.concatenate([prev[:, 1:] + p1, prev[:, -1:] + p1], -1)
        best = np.minimum(np.minimum(prev, up), np.minimum(dn, m + p2))
        out[t] = cost[t] + best - m
    return out


class TestSgmScan:
    @pytest.mark.parametrize("reverse", [False, True])
    def test_direction_matches_naive(self, reverse):
        r = np.random.default_rng(0)
        cost = r.uniform(0, 8, (20, 16, 64)).astype(np.float32)
        seq = cost[::-1] if reverse else cost
        want = naive_scanline(seq, 1.0, 8.0)
        got = np.asarray(_aggregate_scanline(jnp.asarray(seq), 1.0, 8.0))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_4dir_symmetry_and_sum(self):
        r = np.random.default_rng(1)
        cost = r.uniform(0, 8, (12, 14, 32)).astype(np.float32)
        agg = np.asarray(_aggregate_4dir_scan(jnp.asarray(cost), 1.0, 8.0))
        # transposing the image swaps the horizontal and vertical passes
        agg_t = np.asarray(_aggregate_4dir_scan(
            jnp.asarray(np.swapaxes(cost, 0, 1)), 1.0, 8.0))
        np.testing.assert_allclose(agg, np.swapaxes(agg_t, 0, 1), atol=1e-4)
        # and the total is the four naive directions
        c_lr = np.swapaxes(cost, 0, 1)
        want = (np.swapaxes(naive_scanline(c_lr, 1.0, 8.0)
                            + naive_scanline(c_lr[::-1], 1.0, 8.0)[::-1],
                            0, 1)
                + naive_scanline(cost, 1.0, 8.0)
                + naive_scanline(cost[::-1], 1.0, 8.0)[::-1])
        np.testing.assert_allclose(agg, want, atol=1e-3)


# ---------------------------------------------------------------------------
# one GN linearization vs a float64 NumPy build
# ---------------------------------------------------------------------------

def _problem(desc):
    import bench
    rows, cols = 120, 160
    K, baseline, frames = bench.synthesize_sequence(2, rows, cols)
    p = AlgorithmParameters(
        minSaliency=1.0, numPyramidLevels=1,
        descriptor=(DescriptorType.BITPLANES if desc == "BitPlanes"
                    else DescriptorType.INTENSITY))
    cam = warp_mod.CameraModel.from_K(K, baseline)
    ch0 = descriptors.compute(jnp.asarray(frames[0][0]), p)
    ch1 = descriptors.compute(jnp.asarray(frames[1][0]), p)
    td = td_mod.set_data(ch0, jnp.asarray(frames[0][1]), cam, p, 2048, 0)
    return td, ch1, cam


def numpy_linearize(td, ch1, cam, T, sigma, loss):
    """Bilinear residuals, IRLS weights and J^T W J / J^T W r in float64."""
    f64 = np.float64
    X = np.asarray(td.points, f64)
    T = np.asarray(T, f64)
    Xw = X @ T[:3, :3].T + T[:3, 3]
    Z = Xw[:, 2]
    u = float(cam.fx) * Xw[:, 0] / Z + float(cam.cx)
    v = float(cam.fy) * Xw[:, 1] / Z + float(cam.cy)
    C, H, W = ch1.shape
    xi, yi = np.floor(u), np.floor(v)
    ok = (np.asarray(td.valid) & (Z > 1e-6) & (xi >= 0) & (xi < W - 1)
          & (yi >= 0) & (yi < H - 1))
    x0 = np.clip(xi, 0, W - 2).astype(int)
    y0 = np.clip(yi, 0, H - 2).astype(int)
    fx, fy = u - xi, v - yi
    I = np.asarray(ch1, f64)
    samp = ((1 - fy) * ((1 - fx) * I[:, y0, x0] + fx * I[:, y0, x0 + 1])
            + fy * ((1 - fx) * I[:, y0 + 1, x0] + fx * I[:, y0 + 1, x0 + 1]))
    r = np.where(ok, samp - np.asarray(td.pixels, f64), 0.0)
    a = np.abs(r / sigma)
    if loss == LossFunctionType.TUKEY:
        w = np.where(a < 4.685, (1 - (a / 4.685) ** 2) ** 2, 0.0)
    elif loss == LossFunctionType.HUBER:
        w = np.where(a < 1.345, 1.0, 1.345 / np.maximum(a, 1e-20))
    else:
        w = np.ones_like(r)
    w = w * ok
    J = np.asarray(td.jacobians, f64).reshape(-1, 6)
    wf, rf = w.reshape(-1), r.reshape(-1)
    return J.T @ (wf[:, None] * J), J.T @ (wf * rf), w


@pytest.mark.parametrize("desc", ["Intensity", "BitPlanes"])   # C = 1, 8
@pytest.mark.parametrize("loss", [LossFunctionType.TUKEY,
                                  LossFunctionType.HUBER,
                                  LossFunctionType.L2])
def test_linearize_matches_float64(desc, loss):
    td, ch1, cam = _problem(desc)
    T = np.asarray(se3.exp(jnp.asarray(
        [0.0005, 0.001, 0.0008, 0.006, 0.002, 0.03], jnp.float32)))
    sigma = 12.0 if desc == "Intensity" else 0.4
    opts = gn.GNOptions(loss=loss)
    # delta_scale 0: sigma is stable, so the weights use exactly ``sigma``
    H, g, f, s_out, _, w = gn._linearize(
        td, ch1, cam, jnp.asarray(T), jnp.asarray(sigma, jnp.float32),
        jnp.asarray(0.0, jnp.float32), opts)
    H_ref, g_ref, w_ref = numpy_linearize(td, ch1, cam, T, sigma, loss)
    assert float(s_out) == pytest.approx(sigma)
    assert w_ref.sum() > 100
    np.testing.assert_allclose(np.asarray(w), w_ref, atol=2e-4)
    scale = np.abs(H_ref).max()
    np.testing.assert_allclose(np.asarray(H), H_ref, atol=1e-4 * scale)
    # g sums signed residuals, whose float32 projection error (~1e-5 px at
    # u ~ 1e3 px, times the image gradient) does not cancel as it does in H
    np.testing.assert_allclose(np.asarray(g), g_ref,
                               atol=1e-3 * np.abs(g_ref).max())


def test_cosine_interpolation_gn_recovers_motion():
    from test_gn import build_template, render_pair
    from bpvo_tpu.types import InterpolationType
    # cosine weights are a smoothed bilinear, so the optimum sits a little
    # off the exact pose; the bounds are test_gn's synthetic-motion bounds
    I0, I1, D, cam, T_true = render_pair([0.0, 0.0, 0.0, 0.02, 0.0, 0.0])
    td, _ = build_template(I0, D, cam, capacity=2048)
    opts = gn.GNOptions(interp=InterpolationType.COSINE,
                        function_tolerance=1e-4, parameter_tolerance=1e-6)
    st = gn.run(td, jnp.asarray(I1)[None], cam, jnp.eye(4), opts)
    assert bool(st.solver_ok)
    err = np.asarray(se3.log(jnp.asarray(
        np.asarray(st.T) @ np.linalg.inv(T_true), jnp.float32)))
    assert np.abs(err[:3]).max() < 5e-4, err
    assert np.abs(err[3:]).max() < 3e-3, err


def test_census_planes_match_numpy():
    I = synthetic_image(32, 48)
    got = np.asarray(census_ops.census_planes(jnp.asarray(I)))
    want = np.zeros((8,) + I.shape, np.float32)
    for b, (dy, dx) in enumerate(census_ops.NEIGHBOR_OFFSETS):
        for y in range(1, I.shape[0] - 1):
            for x in range(1, I.shape[1] - 1):
                want[b, y, x] = float(I[y + dy, x + dx] >= I[y, x])
    np.testing.assert_array_equal(got, want)
