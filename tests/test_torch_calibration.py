"""The port's chessboard calibration (tpusfm_torch.utils.calibration) against
the JAX reference on the CPU, on the boards of tests/test_calibration.py,
and the port's copy of that test's renderer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from test_calibration import render_board_views  # noqa: E402
from tpusfm.core import homography as jhom  # noqa: E402
from tpusfm.utils import calibration as jcal  # noqa: E402
from tpusfm_torch.core import homography as thom  # noqa: E402
from tpusfm_torch.tools import calib_boards  # noqa: E402
from tpusfm_torch.utils import calibration as tcal  # noqa: E402

torch.set_num_threads(2)

PATTERN = (9, 6)


@pytest.fixture(scope="module")
def boards():
    images, K = render_board_views()
    return images, K, jcal.find_chessboard_corners(images, PATTERN)


@pytest.fixture(scope="module")
def homographies(boards):
    """The reference's per-view homographies of the detected corners."""
    _, _, corners = boards
    obj = jcal.board_points(*PATTERN)[:, :2].astype(np.float32)
    Hs = [np.asarray(jhom.homography_dlt(jnp.asarray(obj), jnp.asarray(c)))
          for c in corners if c is not None]
    return np.stack([H / H[2, 2] for H in Hs])


def test_board_points_and_corners_equal_reference(boards):
    images, _, corners = boards
    np.testing.assert_array_equal(tcal.board_points(9, 6, 2.0), jcal.board_points(9, 6, 2.0))
    got = tcal.find_chessboard_corners(images, PATTERN)
    assert [c is None for c in got] == [c is None for c in corners]
    for g, w in zip(got, corners):
        if w is not None:
            np.testing.assert_array_equal(g, w)
    assert sum(c is not None for c in got) >= 4


def test_renderer_copy_matches_the_test_renderer(boards):
    """tools/calib_boards renders the test's boards: at most one gray level
    apart (its rotation comes from the port's float32 so3_exp), and the
    same boards are found."""
    images, K, corners = boards
    got, K2 = calib_boards.render_board_views()
    np.testing.assert_array_equal(K2, K)
    diff = np.abs(got.astype(np.int32) - images)
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    found = tcal.find_chessboard_corners(got, PATTERN)
    assert [c is None for c in found] == [c is None for c in corners]


def test_homography_init_matches_reference(boards, homographies):
    """The port's batched DLT on the same corners: each homography within
    1e-4 relative of the reference's; Zhang's intrinsics and the poses
    from them equal the reference's on the same homographies."""
    _, _, corners = boards
    views = [c for c in corners if c is not None]
    obj = torch.as_tensor(tcal.board_points(*PATTERN)[:, :2].astype(np.float32))
    Hs = thom.homography_dlt(obj.expand(len(views), -1, -1),
                             torch.as_tensor(np.stack(views))).numpy()
    Hs = Hs / Hs[:, 2:3, 2:3]
    np.testing.assert_allclose(Hs, homographies, rtol=0,
                               atol=1e-4 * np.abs(homographies).max())
    k_t = tcal._intrinsics_from_homographies(homographies)
    k_j = jcal._intrinsics_from_homographies(homographies)
    np.testing.assert_allclose(k_t, k_j, rtol=1e-12)
    K = np.array([[k_t[0], 0, k_t[2]], [0, k_t[1], k_t[3]], [0, 0, 1]])
    for H in homographies:
        for a, b in zip(tcal._pose_from_homography(H, K), jcal._pose_from_homography(H, K)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_calibrate_camera_matches_reference_and_its_bars(boards):
    """On the same corners: intrinsics within 1e-3 relative of the
    reference's (k1, k2 within 1e-3), rms within 1e-3 px; the reference
    test's bars (rms < 0.5 px, fx and fy within 2%, cx and cy within 15 px)."""
    _, K, corners = boards
    ji, jrms, jV = jcal.calibrate_camera(corners, PATTERN)
    ti, trms, tV = tcal.calibrate_camera(corners, PATTERN, device="cpu")
    assert tV == jV
    np.testing.assert_allclose(ti[:4], ji[:4], rtol=1e-3)
    np.testing.assert_allclose(ti[4:], ji[4:], atol=1e-3)
    assert abs(trms - jrms) < 1e-3
    assert trms < 0.5
    assert abs(ti[0] - K[0, 0]) / K[0, 0] < 0.02 and abs(ti[1] - K[1, 1]) / K[1, 1] < 0.02
    assert abs(ti[2] - K[0, 2]) < 15 and abs(ti[3] - K[1, 2]) < 15


def test_calibrate_camera_from_images_and_too_few_views(boards):
    images, K, _ = boards
    intr, rms, V = tcal.calibrate_camera_from_images(images, PATTERN, device="cpu")
    assert V >= 4 and rms < 0.5 and abs(intr[0] - K[0, 0]) / K[0, 0] < 0.02
    with pytest.raises(ValueError, match="need >= 3"):
        tcal.calibrate_camera([None, np.zeros((54, 2), np.float32)], PATTERN, device="cpu")
