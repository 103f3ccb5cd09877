import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from bpvo_tpu.ops import census as census_ops
from bpvo_tpu.ops import descriptors, imgproc, interp, pyramid, selection
from bpvo_tpu.types import InterpolationType
from conftest import synthetic_image


class TestCensus:
    def test_vs_naive(self):
        img = synthetic_image(32, 40).astype(np.uint8)
        got = np.asarray(census_ops.census(jnp.asarray(img)))
        H, W = img.shape
        want = np.zeros((H, W), np.uint8)
        offs = census_ops.NEIGHBOR_OFFSETS
        for y in range(1, H - 1):
            for x in range(1, W - 1):
                v = 0
                for b, (dy, dx) in enumerate(offs):
                    if img[y + dy, x + dx] >= img[y, x]:
                        v |= 1 << b
                want[y, x] = v
        np.testing.assert_array_equal(got, want)

    def test_border_zero(self):
        img = synthetic_image(16, 16)
        c = np.asarray(census_ops.census(jnp.asarray(img)))
        assert c[0].sum() == 0 and c[-1].sum() == 0
        assert c[:, 0].sum() == 0 and c[:, -1].sum() == 0

    def test_planes_match_packed(self):
        img = synthetic_image(24, 24)
        planes = np.asarray(census_ops.census_planes(jnp.asarray(img)))
        packed = census_ops.census(jnp.asarray(img))
        unpacked = np.asarray(census_ops.extract_bitplanes(packed))
        np.testing.assert_array_equal(planes[:, 1:-1, 1:-1], unpacked[:, 1:-1, 1:-1])


class TestImgproc:
    def test_gradients_vs_numpy(self):
        I = synthetic_image(30, 41)
        gx = np.asarray(imgproc.xgradient(jnp.asarray(I)))
        want = 0.5 * (I[:, 2:] - I[:, :-2])
        np.testing.assert_allclose(gx[:, 1:-1], want, atol=1e-4)
        gy = np.asarray(imgproc.ygradient(jnp.asarray(I)))
        want = 0.5 * (I[2:, :] - I[:-2, :])
        np.testing.assert_allclose(gy[1:-1, :], want, atol=1e-4)

    def test_saliency(self):
        I = synthetic_image(30, 40)
        s = np.asarray(imgproc.gradient_absolute_magnitude(jnp.asarray(I)))
        want = (np.abs(I[1:-1, 2:] - I[1:-1, :-2])
                + np.abs(I[2:, 1:-1] - I[:-2, 1:-1]))
        np.testing.assert_allclose(s[1:-1, 1:-1], want, atol=1e-4)
        assert s[0].sum() == 0

    def test_local_max(self):
        r = np.random.default_rng(0)
        S = r.standard_normal((20, 25)).astype(np.float32)
        got = np.asarray(imgproc.is_local_max(jnp.asarray(S), 1))
        for y in range(1, 19):
            for x in range(1, 24):
                nb = S[y - 1:y + 2, x - 1:x + 2].copy()
                v = nb[1, 1]
                nb[1, 1] = -np.inf
                assert got[y, x] == bool(v > nb.max()), (y, x)

    def test_gaussian_vs_cv2(self):
        I = synthetic_image(40, 50)
        sigma = 1.2
        got = np.asarray(imgproc.imsmooth(jnp.asarray(I), sigma, ksize=5))
        want = cv2.GaussianBlur(I, (5, 5), sigma, borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_allclose(got, want, atol=1e-2)

    def test_pyrdown_vs_cv2(self):
        I = synthetic_image(48, 64)
        got = np.asarray(imgproc.pyr_down(jnp.asarray(I)))
        want = cv2.pyrDown(I)
        assert got.shape == want.shape
        # interior matches cv2 closely (borders differ by reflect conventions)
        np.testing.assert_allclose(got[2:-2, 2:-2], want[2:-2, 2:-2], rtol=1e-3, atol=0.15)


class TestPyramid:
    def test_shapes(self):
        I = synthetic_image(120, 160)
        pyr = pyramid.build(jnp.asarray(I), 4)
        shapes = [p.shape for p in pyr]
        assert shapes == pyramid.level_shapes(120, 160, 4)
        assert shapes == [(120, 160), (60, 80), (30, 40), (15, 20)]


class TestInterp:
    @pytest.mark.parametrize("method", list(InterpolationType))
    def test_integer_points_exact(self, method):
        I = synthetic_image(32, 32)
        ch = jnp.asarray(I)[None]
        xs = np.array([5, 10, 15, 20], np.float32)
        ys = np.array([6, 11, 16, 21], np.float32)
        valid = interp.valid_mask(xs, ys, 32, 32, method)
        out = np.asarray(interp.sample(ch, jnp.asarray(xs), jnp.asarray(ys),
                                       valid, method))
        want = I[ys.astype(int), xs.astype(int)]
        np.testing.assert_allclose(out[0], want, rtol=1e-5)

    def test_bilinear_vs_manual(self):
        I = synthetic_image(32, 32)
        ch = jnp.asarray(I)[None]
        u = np.array([5.25, 10.75], np.float32)
        v = np.array([6.5, 12.1], np.float32)
        valid = jnp.ones(2, bool)
        out = np.asarray(interp.sample(ch, jnp.asarray(u), jnp.asarray(v), valid,
                                       InterpolationType.LINEAR))[0]
        for i in range(2):
            x0, y0 = int(u[i]), int(v[i])
            xf, yf = u[i] - x0, v[i] - y0
            want = ((1 - yf) * ((1 - xf) * I[y0, x0] + xf * I[y0, x0 + 1])
                    + yf * ((1 - xf) * I[y0 + 1, x0] + xf * I[y0 + 1, x0 + 1]))
            np.testing.assert_allclose(out[i], want, rtol=1e-5)

    def test_out_of_bounds_masked(self):
        ch = jnp.ones((1, 16, 16))
        u = jnp.asarray(np.array([-5.0, 3.0, 40.0], np.float32))
        v = jnp.asarray(np.array([2.0, 3.0, 2.0], np.float32))
        valid = interp.valid_mask(u, v, 16, 16, InterpolationType.LINEAR)
        np.testing.assert_array_equal(np.asarray(valid), [False, True, False])
        out = np.asarray(interp.sample(ch, u, v, valid, InterpolationType.LINEAR))
        np.testing.assert_allclose(out[0], [0.0, 1.0, 0.0])

    @pytest.mark.parametrize("method", list(InterpolationType))
    @pytest.mark.parametrize("C", [1, 3])
    def test_packed_matches_sample(self, method, C):
        """The one-gather packed path must equal the reference sampler,
        including clamped out-of-range points."""
        rng = np.random.default_rng(3)
        ch = jnp.asarray(rng.random((C, 24, 31)).astype(np.float32) * 255)
        u = jnp.asarray(rng.uniform(-2, 33, 200).astype(np.float32))
        v = jnp.asarray(rng.uniform(-2, 26, 200).astype(np.float32))
        valid = interp.valid_mask(u, v, 24, 31, method)
        want = np.asarray(interp.sample(ch, u, v, valid, method))
        packed = interp.pack_taps(ch, method)
        got = np.asarray(interp.sample_packed(packed, u, v, valid, method))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_packed_taps_bf16_storage(self):
        """bf16 tap storage (GNOptions.taps_dtype option): arithmetic stays
        f32, error bounded by the bf16 value quantization (~0.4%)."""
        from bpvo_tpu.types import InterpolationType
        rng = np.random.default_rng(5)
        ch = jnp.asarray(rng.random((8, 24, 31)).astype(np.float32))
        u = jnp.asarray(rng.uniform(0, 29, 200).astype(np.float32))
        v = jnp.asarray(rng.uniform(0, 22, 200).astype(np.float32))
        m = InterpolationType.LINEAR
        valid = interp.valid_mask(u, v, 24, 31, m)
        want = np.asarray(interp.sample(ch, u, v, valid, m))
        packed = interp.pack_taps(ch, m, dtype=jnp.bfloat16)
        assert packed.data.dtype == jnp.bfloat16
        got = np.asarray(interp.sample_packed(packed, u, v, valid, m))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=8e-3)
        # bf16pack: pairs of bf16 taps bitcast into f32 gather words —
        # identical quantization to plain bf16 storage
        pp = interp.pack_taps(ch, m, dtype="bf16pack")
        assert pp.pair_packed and pp.data.dtype == jnp.float32
        assert pp.data.shape[1] == packed.data.shape[1] // 2
        got2 = np.asarray(interp.sample_packed(pp, u, v, valid, m))
        np.testing.assert_allclose(got2, got, atol=0, rtol=0)


class TestDescriptors:
    def test_channel_counts(self):
        from bpvo_tpu.config import AlgorithmParameters
        from bpvo_tpu.types import DescriptorType
        I = jnp.asarray(synthetic_image(32, 40))
        for t in DescriptorType:
            p = AlgorithmParameters(descriptor=t)
            ch = descriptors.compute(I, p)
            assert ch.shape == (descriptors.num_channels(t, p), 32, 40), t

    def test_bitplanes_binary_when_unsmoothed(self):
        I = jnp.asarray(synthetic_image(32, 40))
        ch = np.asarray(descriptors.bitplanes(I, sigma_ct=-1.0, sigma_bp=-1.0))
        assert set(np.unique(ch)) <= {0.0, 1.0}

    def test_intensity_and_gradient(self):
        I = synthetic_image(20, 30)
        ch = np.asarray(descriptors.intensity_and_gradient(jnp.asarray(I)))
        np.testing.assert_allclose(ch[0], I, atol=1e-5)
        np.testing.assert_allclose(ch[1][:, 1:-1], 0.5 * (I[:, 2:] - I[:, :-2]), atol=1e-4)

    def test_shift_clamp_vs_numpy(self):
        I = synthetic_image(13, 17)
        yy, xx = np.mgrid[0:13, 0:17]
        for dy, dx in [(0, 0), (3, -2), (-5, 7), (8, 8), (-8, -8)]:
            out = np.asarray(descriptors.shift_clamp(jnp.asarray(I), dy, dx))
            ref = I[np.clip(yy + dy, 0, 12), np.clip(xx + dx, 0, 16)]
            np.testing.assert_array_equal(out, ref, err_msg=f"({dy},{dx})")

    def test_latch_no_border_wraparound(self):
        """A border-localized perturbation must not change channels at the
        OPPOSITE border (the jnp.roll bug VERDICT r1 flagged: ±8 px offsets
        wrapped content across the frame)."""
        I = synthetic_image(40, 48)
        I2 = I.copy()
        I2[:, -2:] += 100.0  # touch the right edge only
        a = np.asarray(descriptors.latch(jnp.asarray(I)))
        b = np.asarray(descriptors.latch(jnp.asarray(I2)))
        # halo from the right edge: max triplet offset (24) + ssd radius (1)
        # + post-smooth radius (6, sigma 1.75) + pre-blur radius (1) => the
        # perturbation can reach column 48-2-32 = 14; columns < 12 must be
        # identical (wraparound would corrupt them all the way to column 0)
        np.testing.assert_array_equal(a[:, :, :12], b[:, :, :12])

    def test_central_difference_no_wraparound(self):
        I = synthetic_image(30, 36)
        I2 = I.copy()
        I2[:2, :] += 50.0  # top edge
        a = np.asarray(descriptors.central_difference(jnp.asarray(I)))
        b = np.asarray(descriptors.central_difference(jnp.asarray(I2)))
        # halo: pre-smooth (±2) + shift (±3) + post-smooth (±6) ≈ 11 rows
        np.testing.assert_array_equal(a[:, 16:, :], b[:, 16:, :])

    def test_saliency_positive_on_texture(self):
        I = jnp.asarray(synthetic_image(40, 40))
        from bpvo_tpu.config import AlgorithmParameters
        ch = descriptors.compute(I, AlgorithmParameters())
        s = np.asarray(descriptors.saliency(ch))
        assert s.shape == (40, 40)
        assert (s[5:-5, 5:-5] > 0).mean() > 0.9


class TestSelection:
    def test_basic(self):
        H, W = 64, 64
        sal = np.zeros((H, W), np.float32)
        # plant 10 distinct peaks
        peaks = [(10 + 3 * i, 8 + 4 * i) for i in range(10)]
        for i, (y, x) in enumerate(peaks):
            sal[y, x] = 10.0 + i
        disp = np.full((H, W), 5.0, np.float32)
        sel = selection.select_pixels(
            jnp.asarray(sal), jnp.asarray(disp), 16,
            min_saliency=1.0, nms_radius=1, use_nms=True,
            min_disparity=0.1, max_disparity=100.0, border=3)
        assert int(sel.num_valid) == 10
        got = {(int(y), int(x)) for y, x, ok in
               zip(sel.rows, sel.cols, sel.valid) if ok}
        assert got == set(peaks)

    def test_disparity_gate(self):
        H, W = 32, 32
        sal = np.full((H, W), 5.0, np.float32)
        disp = np.zeros((H, W), np.float32)
        disp[10, 10] = 3.0
        sel = selection.select_pixels(
            jnp.asarray(sal), jnp.asarray(disp), 8,
            min_saliency=1.0, nms_radius=0, use_nms=False,
            min_disparity=0.5, max_disparity=100.0, border=3)
        assert int(sel.num_valid) == 1
        assert (int(sel.rows[0]), int(sel.cols[0])) == (10, 10)

    def test_valid_points_first_in_raster_order(self):
        """With capacity only part-filled, the valid points fill slots
        [0, num_valid) in raster order (coalesced warped gathers) and the
        padding slots after them are invalid."""
        H, W = 96, 128
        r = np.random.default_rng(7)
        sal = r.uniform(0, 1, (H, W)).astype(np.float32)
        sal[sal < 0.8] = 0.0  # ~20% of pixels selectable (under capacity)
        disp = np.full((H, W), 5.0, np.float32)
        cap = 4096
        sel = selection.select_pixels(
            jnp.asarray(sal), jnp.asarray(disp), cap,
            min_saliency=0.1, nms_radius=0, use_nms=False,
            min_disparity=0.1, max_disparity=100.0, border=3)
        nv = int(sel.num_valid)
        assert 0 < nv < cap  # part-filled, the interesting regime
        valid = np.asarray(sel.valid)
        assert valid[:nv].all() and not valid[nv:].any()
        ridx = (np.asarray(sel.rows)[:nv].astype(np.int64) * W
                + np.asarray(sel.cols)[:nv])
        assert np.all(np.diff(ridx) > 0)
        # exactly the gated pixels inside the border
        inner = np.zeros((H, W), bool)
        inner[3:H - 4, 3:W - 4] = True
        want = np.flatnonzero((sal >= 0.1) & inner)
        np.testing.assert_array_equal(ridx, want)

    def test_capacity_overflow_keeps_most_salient(self):
        H, W = 32, 32
        r = np.random.default_rng(1)
        sal = r.uniform(1, 2, (H, W)).astype(np.float32)
        disp = np.full((H, W), 5.0, np.float32)
        sel = selection.select_pixels(
            jnp.asarray(sal), jnp.asarray(disp), 16,
            min_saliency=0.0, nms_radius=0, use_nms=False,
            min_disparity=0.1, max_disparity=100.0, border=3)
        assert int(sel.num_valid) == 16
        inner = sal[3:H - 4, 3:W - 4]
        want = np.sort(inner.reshape(-1))[-16:]
        got = np.sort(np.asarray(sal)[np.asarray(sel.rows), np.asarray(sel.cols)])
        np.testing.assert_allclose(got, want)
