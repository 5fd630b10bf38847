"""The port's ORB (ops/orb.py) against OpenCV's, on the CPU.

OpenCV is not a dependency of the port; these tests use the cv2 of the
environment that has it (skipped elsewhere) and hold each step of the
port's ORB against it: the gray conversion, the exact bilinear pyramid,
ORB's blur and the sampling pattern bit for bit; the descriptors at
keypoints passed in bit-equal at angles 0-359 and levels 0-3; the
detector by recall (>= 90% of cv2's level-0 keypoints within 1 px) and
angle (within 2 degrees on the matched ones); and place recognition on the
segment anchors of the synthetic room by outcome (the same top-1, baseline
scores within 0.02). The detector is exact on these images (recall 1.0,
angles equal); the tolerances leave room for OpenCV builds that differ.
"""

import numpy as np
import pytest
import torch

from loopy_slam_torch.mapping import place_recognition as tpr
from loopy_slam_torch.ops import orb
from loopy_slam_torch.ops.orb_pattern import PATTERN_31
from loopy_slam_tpu.config import DEFAULTS, update_recursive
from loopy_slam_tpu.utils.datasets import Synthetic
from torch_cpu import torch_cpu  # noqa: F401  (fixture)

cv2 = pytest.importorskip("cv2")

ROOM_CAM = {"H": 340, "W": 600, "fx": 300.0, "fy": 300.0, "cx": 299.5,
            "cy": 169.5, "png_depth_scale": 6553.5, "crop_edge": 0}


@pytest.fixture(scope="module")
def room():
    import copy

    cfg = copy.deepcopy(DEFAULTS)
    update_recursive(cfg, {"dataset": "synthetic", "cam": ROOM_CAM,
                           "data": {"n_frames": 31}})
    return Synthetic(cfg)


def _cv_gray(color):
    c8 = np.clip(np.asarray(color) * 255.0, 0, 255).astype(np.uint8)
    return cv2.cvtColor(c8, cv2.COLOR_RGB2GRAY)


def _images(room):
    rng = np.random.default_rng(0)
    smooth = cv2.resize(rng.uniform(0, 1, (30, 40, 3)).astype(np.float32),
                        (600, 340), interpolation=cv2.INTER_CUBIC)
    noise = rng.uniform(0, 1, (340, 600, 3)).astype(np.float32)
    return [room[i][1] for i in (0, 15, 30)] + [np.clip(smooth, 0, 1), noise]


def test_gray_pyramid_and_blur_are_opencvs(room, torch_cpu):
    for color in _images(room):
        gray = orb.to_gray(torch.from_numpy(color))
        ref = _cv_gray(color)
        np.testing.assert_array_equal(gray.numpy(), ref)
        ref_lv, lv = ref, gray
        for s in orb.level_scales()[1:4]:  # each level from the one above
            H, W = orb.level_size(340, 600, s)
            ref_lv = cv2.resize(ref_lv, (W, H),
                                interpolation=cv2.INTER_LINEAR_EXACT)
            lv = orb.resize_linear_exact(lv, H, W)
            np.testing.assert_array_equal(lv.numpy(), ref_lv)
        k = cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F)
        np.testing.assert_array_equal(k[:, 0], orb._GAUSS7)
        blurred = cv2.sepFilter2D(_cv_gray(color), -1, k, k,
                                  borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(orb.gaussian_blur(gray).numpy(),
                                      blurred)


def recover_pattern(n_images=6, seed=5):
    """OpenCV's 256 point pairs from ORB.compute at level 0, angle 0 (see
    ops/orb_pattern.py): each bit compares two blurred pixels, and exactly
    one pair of offsets in the 31x31 patch agrees with every probe."""
    rng = np.random.default_rng(seed)
    H, W = 200, 260
    offs = np.array([(x, y) for y in range(-15, 16) for x in range(-15, 16)])
    k32 = cv2.getGaussianKernel(7, 2, ktype=cv2.CV_32F)
    V, bits = [], []
    for it in range(n_images):
        img = rng.integers(0, 256, (H, W), dtype=np.uint8)
        if it % 2:
            img = cv2.resize(rng.integers(0, 256, (20, 26), dtype=np.uint8),
                             (W, H), interpolation=cv2.INTER_LINEAR)
        kps = [cv2.KeyPoint(float(x), float(y), 31.0, 0.0, 0.0, 0)
               for y in range(40, H - 40, 5) for x in range(40, W - 40, 5)]
        kps, des = cv2.ORB_create().compute(img, kps)
        B = cv2.sepFilter2D(img, -1, k32, k32,
                            borderType=cv2.BORDER_REFLECT_101).astype(int)
        p = np.array([[round(k.pt[0]), round(k.pt[1])] for k in kps])
        V.append(B[p[:, 1:2] + offs[None, :, 1], p[:, 0:1] + offs[None, :, 0]])
        bits.append(np.unpackbits(des, axis=1, bitorder="little"))
    V, bits = np.concatenate(V), np.concatenate(bits).astype(bool)
    K = 60  # the first 60 probes as a 60-bit code per pair, then all
    code = np.zeros((len(offs), len(offs)), np.int64)
    for i in range(K):
        code |= (V[i][:, None] < V[i][None, :]).astype(np.int64) << i
    want = (bits[:K].astype(np.int64) << np.arange(K)[:, None]).sum(0)
    pairs = []
    for j in range(256):
        cand = [(a, b) for a, b in zip(*np.nonzero(code == want[j]))
                if np.array_equal(V[:, a] < V[:, b], bits[:, j])]
        assert len(cand) == 1, (j, len(cand))
        a, b = cand[0]
        pairs.append(tuple(int(v) for v in (*offs[a], *offs[b])))
    return tuple(pairs)


def test_pattern_is_recovered_from_cv2():
    assert recover_pattern() == PATTERN_31


@pytest.mark.parametrize("which", ["room0", "room15", "smooth", "noise"])
def test_descriptors_at_keypoints_passed_in_are_bit_equal(room, which,
                                                          torch_cpu):
    color = {"room0": lambda: room[0][1], "room15": lambda: room[15][1],
             "smooth": lambda: _images(room)[3],
             "noise": lambda: _images(room)[4]}[which]()
    gray = _cv_gray(color)
    scales = orb.level_scales(4)
    xs, ys, angles, levels, kps = [], [], [], [], []
    n = 0
    for lv, s in enumerate(scales):
        H, W = orb.level_size(340, 600, s)
        for y in range(32, H - 32, 9):
            for x in range(32, W - 32, 11):
                a = np.float32((n * 7) % 360 + (0.25 if n % 3 else 0.0))
                px, py = np.float32(x * s), np.float32(y * s)
                kps.append(cv2.KeyPoint(float(px), float(py), 31.0 * s,
                                        float(a), 0.0, lv))
                xs.append(px)
                ys.append(py)
                angles.append(a)
                levels.append(lv)
                n += 1
    kps_out, want = cv2.ORB_create().compute(gray, kps)
    assert len(kps_out) == n
    got = orb.compute_at(torch.from_numpy(gray.astype(np.int32)),
                         np.array(xs), np.array(ys), np.array(angles),
                         np.array(levels))
    assert {int(a) for a in angles} == set(range(360))
    np.testing.assert_array_equal(got.numpy(), want)


def test_detector_recall_and_angles(room, torch_cpu):
    recalls = []
    for color in _images(room)[:4]:
        gray = _cv_gray(color)
        kps, des = cv2.ORB_create().detectAndCompute(gray, None)
        kp, tdes = orb.detect_and_compute(orb.to_gray(
            torch.from_numpy(color)))
        assert tdes.shape[1] == 32 and len(tdes) == len(kp.x) > 100
        cv0 = np.array([[k.pt[0], k.pt[1], k.angle] for k in kps
                        if k.octave == 0])
        m0 = (kp.level == 0).numpy()
        mine = np.stack([kp.x.numpy()[m0], kp.y.numpy()[m0],
                         kp.angle.numpy()[m0]], 1)
        d = np.abs(cv0[:, None, :2] - mine[None, :, :2]).max(-1)
        hit = d.min(1) <= 1.0
        recalls.append(hit.mean())
        j = d.argmin(1)[hit]
        da = np.abs(cv0[hit, 2] - mine[j, 2])
        assert np.minimum(da, 360 - da).max() <= 2.0
    assert min(recalls) >= 0.9, recalls


def test_place_recognition_outcome_matches_cv2_descriptors(room,
                                                           torch_cpu):
    """The anchors of the 7-segment session (frames 0, 5, .., 30) in a
    ScoreDB; each anchor's next frame queries it. The port's descriptors
    and cv2's give the same top-1, and the first three segments' baseline
    scores (anchor against its next four frames) agree within 0.02."""
    from loopy_slam_tpu.mapping.place_recognition import extract_orb

    anchors = list(range(0, 31, 5))
    used = sorted(set(anchors) | {a + j for a in anchors[:3]
                                  for j in range(1, 5)}
                  | {a + 1 for a in anchors[:-1]})
    frames = {i: room[i][1] for i in used}
    mine = {i: orb.extract_orb(c, "cpu") for i, c in frames.items()}
    ref = {i: extract_orb(c) for i, c in frames.items()}
    tops = []
    for des in (mine, ref):
        db = tpr.ScoreDB(device="cpu")
        for a in anchors:
            db.add(des[a])
        tops.append([db.query(des[a + 1], 2)[0].Id for a in anchors[:-1]])
    assert tops[0] == tops[1] == list(range(len(anchors) - 1))
    for a in anchors[:3]:
        got = tpr.baseline_score(
            mine[a], [mine[i] for i in range(a + 1, a + 5)], device="cpu")
        want = tpr.baseline_score(
            ref[a], [ref[i] for i in range(a + 1, a + 5)], device="cpu")
        assert abs(got - want) <= 0.02, (a, got, want)
