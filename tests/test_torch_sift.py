"""Image ops and SIFT parity: the port against the JAX reference on seeded
images and on two rendered orbit views (240 x 320, 3 octaves, 512
features).  Image ops agree to atol 1e-5.  Keypoints: at least 95% of the
reference's valid keypoints have a port keypoint within 0.05 px at the same
scale, and at least 95% of those carry u8 descriptors within 1 unit in every
bin; the rest is float32 ties at the contrast threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusfm.features import sift as jsift
from tpusfm.ops import image as jimg
from tpusfm_torch.features import sift as tsift
from tpusfm_torch.ops import image as timg
from tpusfm_torch.utils.synth_render import render_orbit_images

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((2, 37, 53)).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.0, 0.8, 1.6, 3.1])
def test_blur(images, sigma):
    j = np.asarray(jimg.blur(jnp.asarray(images), sigma))
    t = timg.blur(torch.as_tensor(images), sigma).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_resampling_and_gradients(images):
    x = torch.as_tensor(images)
    np.testing.assert_array_equal(timg.downsample2(x).numpy(),
                                  np.asarray(jimg.downsample2(jnp.asarray(images))))
    np.testing.assert_allclose(timg.upsample2(x).numpy(),
                               np.asarray(jimg.upsample2(jnp.asarray(images))), atol=1e-5)
    jm, ja = jimg.gradients(jnp.asarray(images))
    tm, ta = timg.gradients(x)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)
    # Angles wrap at 2 pi: compare on the circle.
    d = np.angle(np.exp(1j * (ta.numpy() - np.asarray(ja))))
    np.testing.assert_allclose(d, 0.0, atol=1e-5)
    rgb = (np.random.default_rng(1).random((2, 9, 7, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(timg.to_grayscale(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jimg.to_grayscale(jnp.asarray(rgb))), atol=1e-6)
    ys = np.random.default_rng(2).uniform(-2, 40, (50,)).astype(np.float32)
    xs = np.random.default_rng(3).uniform(-2, 55, (50,)).astype(np.float32)
    np.testing.assert_allclose(
        timg.bilinear_sample(x[0], torch.as_tensor(ys), torch.as_tensor(xs)).numpy(),
        np.asarray(jimg.bilinear_sample(jnp.asarray(images[0]), jnp.asarray(ys), jnp.asarray(xs))),
        atol=1e-5)


def test_detect_and_describe_matches_reference():
    imgs, _ = render_orbit_images(n_views=2, img_h=240, img_w=320, focal=0.9 * 320,
                                  arc_deg=30.0, seed=1)
    jcfg = jsift.SiftConfig(n_octaves=3, max_per_octave=512, max_features=512)
    tcfg = tsift.SiftConfig(n_octaves=3, max_per_octave=512, max_features=512)
    jf = jsift.detect_and_describe(jnp.asarray(imgs), jcfg)
    tf = tsift.detect_and_describe(torch.as_tensor(imgs), tcfg)
    for v in range(2):
        jm = np.asarray(jf.mask[v])
        tm = tf.mask[v].numpy()
        jkp, tkp = np.asarray(jf.kp[v])[jm], tf.kp[v].numpy()[tm]
        jd, td = np.asarray(jf.desc[v])[jm], tf.desc[v].numpy()[tm]
        assert len(jkp) > 100
        dxy = np.linalg.norm(jkp[:, None, :2] - tkp[None, :, :2], axis=-1)
        same_scale = np.abs(jkp[:, None, 2] - tkp[None, :, 2]) < 1e-3 * jkp[:, None, 2]
        dxy = np.where(same_scale, dxy, np.inf)
        nearest = np.argmin(dxy, axis=1)
        hit = dxy[np.arange(len(jkp)), nearest] < 0.05
        assert hit.mean() >= 0.95, hit.mean()
        ddesc = np.abs(jd[hit] - td[nearest[hit]]).max(axis=1)
        assert (ddesc <= 1.0).mean() >= 0.95, (ddesc <= 1.0).mean()
