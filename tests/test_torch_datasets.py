"""The port's dataset readers without OpenCV, against cv2 and the JAX
package's ``utils/datasets.py`` / ``utils/config.py``.

- The PNG decoder (``utils/png``) equals ``cv2.imread`` bit for bit, with
  IMREAD_GRAYSCALE and IMREAD_UNCHANGED, on fixtures of bit depth 8 and
  16 in colour types 0, 2, 3, 4 and 6, written by the small encoder here
  with each of the five row filters forced (and one file mixing them).
- The writer's files read back through cv2 bit for bit.
- The loaders give what the JAX package's give on synthetic EuRoC, TUM
  RGB-D and KITTI directories.
- ``stereo_rectify_maps`` / ``rectify`` equal the JAX package's (which
  call ``cv2.initUndistortRectifyMap`` and ``cv2.remap``): the maps and
  the uint8 remap exactly, the float32 remap within 1e-4 (the port
  rounds its fused multiply-adds through float64).
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from orb_slam3_detailed_comments_tpu.utils import config as jconfig
from orb_slam3_detailed_comments_tpu.utils import datasets as jdatasets
from orb_slam3_detailed_comments_tpu_torch.utils import config, datasets, png

_CH = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _encode(pix, depth, ctype, filt, plte=None, trns=None):
    """A PNG with every row under filter `filt` (-1: row y takes y % 5)."""
    H = pix.shape[0]
    data = np.ascontiguousarray(pix, ">u2" if depth == 16 else np.uint8)
    data = data.view(np.uint8).reshape(H, -1).astype(np.int32)
    bpp = _CH[ctype] * depth // 8
    out, prior = [], np.zeros(data.shape[1], np.int32)
    for y in range(H):
        cur, f = data[y], (filt if filt >= 0 else y % 5)
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        b = prior
        if f == 0:
            r = cur
        elif f == 1:
            r = cur - a
        elif f == 2:
            r = cur - b
        elif f == 3:
            r = cur - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            r = cur - np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, b, c))
        out.append(bytes([f]) + (r & 255).astype(np.uint8).tobytes())
        prior = cur

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body)))

    W = pix.shape[1]
    s = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                                   ctype, 0, 0, 0))
    if plte is not None:
        s += chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        s += chunk(b"tRNS", trns.tobytes())
    return s + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(
        b"IEND", b"")


def _fixture(rng, depth, ctype, H=17, W=23):
    plte = trns = None
    if ctype == 3:
        pix = rng.integers(0, 40, (H, W)).astype(np.uint8)
        plte = rng.integers(0, 256, (40, 3)).astype(np.uint8)
        trns = rng.integers(0, 256, 10).astype(np.uint8)
    else:
        shape = (H, W, _CH[ctype]) if _CH[ctype] > 1 else (H, W)
        pix = rng.integers(0, 2 ** depth, shape).astype(
            np.uint16 if depth == 16 else np.uint8)
        if _CH[ctype] >= 3:             # a few grey pixels: R = G = B
            pix[:3, :, 1] = pix[:3, :, 0]
            pix[:3, :, 2] = pix[:3, :, 0]
    return pix, plte, trns


@pytest.mark.parametrize("depth,ctype", [(8, 0), (8, 2), (8, 3), (8, 4),
                                         (8, 6), (16, 0), (16, 2), (16, 4),
                                         (16, 6)])
def test_png_decoder_equals_cv2_imread(tmp_path, depth, ctype):
    rng = np.random.default_rng(depth * 10 + ctype)
    for filt in (-1, 0, 1, 2, 3, 4):
        pix, plte, trns = _fixture(rng, depth, ctype)
        path = str(tmp_path / f"f{filt}.png")
        with open(path, "wb") as f:
            f.write(_encode(pix, depth, ctype, filt, plte,
                            trns if filt == 2 else None))
        want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        got = png.imread_gray(path)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"filter {filt}")
        np.testing.assert_array_equal(datasets.read_gray(path),
                                      want.astype(np.float32))
        want_u = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got_u = png.imread_unchanged(path)
        assert got_u.dtype == want_u.dtype and got_u.shape == want_u.shape
        np.testing.assert_array_equal(got_u, want_u)
        if ctype == 0:
            np.testing.assert_array_equal(
                datasets.read_depth(path, 5000.0),
                jdatasets.read_depth(path, 5000.0))


@pytest.mark.parametrize("kind", ["gray8", "bgr8", "depth16"])
def test_png_writer_reads_back_through_cv2(tmp_path, kind):
    rng = np.random.default_rng(1)
    img = {"gray8": rng.integers(0, 256, (31, 45)).astype(np.uint8),
           "bgr8": rng.integers(0, 256, (31, 45, 3)).astype(np.uint8),
           "depth16": rng.integers(0, 65536, (31, 45)).astype(np.uint16),
           }[kind]
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert back.dtype == img.dtype
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.imread_unchanged(path), img)


def test_unreadable_files_raise_naming_the_path(tmp_path):
    not_png = tmp_path / "a.png"
    not_png.write_bytes(b"GIF89a not a png")
    with pytest.raises(ValueError, match="a.png"):
        datasets.read_gray(str(not_png))
    inter = bytearray(png.encode_png(np.zeros((4, 5), np.uint8)))
    inter[8 + 8 + 12] = 1                           # IHDR interlace byte
    body = bytes(inter[12:12 + 4 + 13])
    inter[12 + 4 + 13:12 + 4 + 13 + 4] = struct.pack(">I", zlib.crc32(body))
    (tmp_path / "i.png").write_bytes(bytes(inter))
    with pytest.raises(ValueError, match="i.png.*interlaced"):
        datasets.read_gray(str(tmp_path / "i.png"))
    with pytest.raises(FileNotFoundError):
        datasets.read_gray(str(tmp_path / "missing.png"))


# ---- the loaders against the JAX package's ---------------------------------

def _euroc_dir(root, n=5, csv=True, imu=True):
    rng = np.random.default_rng(0)
    for cam in ("cam0", "cam1"):
        d = root / "mav0" / cam / "data"
        d.mkdir(parents=True)
        names = []
        for i in range(n):
            ns = 1_403_636_579_763_555_584 + i * 50_000_000
            png.write_png(str(d / f"{ns}.png"),
                          rng.integers(0, 256, (12, 16)).astype(np.uint8))
            names.append(f"{ns},{ns}.png")
        if csv:
            (root / "mav0" / cam / "data.csv").write_text(
                "#timestamp [ns],filename\n" + "\n".join(names) + "\n")
    if imu:
        (root / "mav0" / "imu0").mkdir(parents=True)
        rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
        for k in range(40):
            ns = 1_403_636_579_758_555_392 + k * 5_000_000
            rows.append(",".join([str(ns)] + [f"{v:.6f}" for v in
                                              rng.normal(0, 1, 6)]))
        (root / "mav0" / "imu0" / "data.csv").write_text("\n".join(rows))


@pytest.mark.parametrize("csv", [True, False])
def test_euroc_loaders_equal_jax(tmp_path, csv):
    _euroc_dir(tmp_path, csv=csv)
    for cam in ("cam0", "cam1"):
        p, ts = datasets.load_euroc_images(str(tmp_path), cam=cam)
        jp, jts = jdatasets.load_euroc_images(str(tmp_path), cam=cam)
        assert p == jp and np.array_equal(ts, jts) and len(p) == 5
    for got, want in zip(datasets.load_euroc_imu(str(tmp_path)),
                         jdatasets.load_euroc_imu(str(tmp_path))):
        np.testing.assert_array_equal(got, want)
    imu_ts = datasets.load_euroc_imu(str(tmp_path))[0]
    assert (datasets.imu_between(imu_ts, ts[1], ts[3])
            == jdatasets.imu_between(imu_ts, ts[1], ts[3]))
    for a, b in zip(datasets.prefetch_gray(p, depth=2),
                    jdatasets.prefetch_gray(p, depth=2)):
        np.testing.assert_array_equal(a, b)


def test_tum_and_kitti_loaders_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    rgb_l, d_l = [], []
    for i in range(6):
        ts = 1.0 + i * 0.033
        png.write_png(str(tmp_path / "rgb" / f"{ts:.6f}.png"),
                      rng.integers(0, 256, (10, 14, 3)).astype(np.uint8))
        png.write_png(str(tmp_path / "depth" / f"{ts + 0.004:.6f}.png"),
                      rng.integers(0, 60000, (10, 14)).astype(np.uint16))
        rgb_l.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        d_l.append(f"{ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png")
    (tmp_path / "rgb.txt").write_text("# ts f\n" + "\n".join(rgb_l) + "\n")
    (tmp_path / "depth.txt").write_text("# ts f\n" + "\n".join(d_l) + "\n")
    got = datasets.load_tum_rgbd(str(tmp_path))
    want = jdatasets.load_tum_rgbd(str(tmp_path))
    for g, w in zip(got, want):
        assert list(g) == list(w)
    pairs = np.asarray(datasets.associate_rgbd(got[1], got[3]))
    np.testing.assert_array_equal(
        pairs, np.asarray(jdatasets.associate_rgbd(want[1], want[3])))
    assert len(pairs) == 6
    for ri, di in pairs:
        np.testing.assert_array_equal(datasets.read_gray(got[0][ri]),
                                      jdatasets.read_gray(got[0][ri]))
        np.testing.assert_array_equal(datasets.read_depth(got[2][di]),
                                      jdatasets.read_depth(got[2][di]))
    for d in ("image_0", "image_1"):
        (tmp_path / d).mkdir()
        for i in range(4):
            png.write_png(str(tmp_path / d / f"{i:06d}.png"),
                          np.full((6, 8), i, np.uint8))
    np.savetxt(tmp_path / "times.txt", np.arange(4) * 0.1)
    for g, w in zip(datasets.load_kitti_stereo(str(tmp_path)),
                    jdatasets.load_kitti_stereo(str(tmp_path))):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_prefetch_resizes_and_closes_early(tmp_path):
    _euroc_dir(tmp_path, n=8, imu=False)
    p, _ = datasets.load_euroc_images(str(tmp_path))
    got = list(datasets.prefetch_gray(p, resize_to=(8, 6)))
    want = list(jdatasets.prefetch_gray(p, resize_to=(8, 6)))
    assert len(got) == 8 and got[0].shape == (6, 8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-3)
    it = datasets.prefetch_gray(p, depth=1)
    next(it)
    it.close()                                   # the worker exits
    with pytest.raises(FileNotFoundError):
        list(datasets.prefetch_gray([str(tmp_path / "none.png")]))


# ---- stereo rectification against cv2 -------------------------------------

RECT_YAML = """%YAML:1.0
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.width: 752
Camera.height: 480
Camera.bf: 47.90639384423901
LEFT.width: 752
LEFT.height: 480
LEFT.K: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.D: !!opencv-matrix
  rows: 1
  cols: 5
  dt: d
  data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.R: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
         0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
         -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P: !!opencv-matrix
  rows: 3
  cols: 4
  dt: d
  data: [435.2046959714599, 0.0, 367.4517211914062, 0.0,
         0.0, 435.2046959714599, 252.2008514404297, 0.0, 0.0, 0.0, 1.0, 0.0]
RIGHT.width: 752
RIGHT.height: 480
RIGHT.K: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1.0]
RIGHT.D: !!opencv-matrix
  rows: 1
  cols: 5
  dt: d
  data: [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0]
RIGHT.R: !!opencv-matrix
  rows: 3
  cols: 3
  dt: d
  data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
         0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
         -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P: !!opencv-matrix
  rows: 3
  cols: 4
  dt: d
  data: [435.2046959714599, 0.0, 367.4517211914062, -47.90639384423901,
         0.0, 435.2046959714599, 252.2008514404297, 0.0, 0.0, 0.0, 1.0, 0.0]
"""


def test_stereo_rectification_equals_jax_cv2(tmp_path):
    y = tmp_path / "stereo.yaml"
    y.write_text(RECT_YAML)
    got = config.stereo_rectify_maps(config.load_settings(str(y)))
    want = jconfig.stereo_rectify_maps(jconfig.load_settings(str(y)))
    for side in (0, 1):
        for a, b in zip(got[side], want[side]):
            assert a.dtype == np.float32 and a.shape == (480, 752)
            np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]
    assert got[3] == pytest.approx(want[3], abs=1e-12)
    rng = np.random.default_rng(5)
    img8 = rng.integers(0, 256, (480, 752)).astype(np.uint8)
    for side in (0, 1):
        np.testing.assert_array_equal(config.rectify(img8, got[side]),
                                      jconfig.rectify(img8, want[side]))
        imgf = img8.astype(np.float32)
        r = config.rectify(imgf, got[side])
        assert r.dtype == np.float32
        np.testing.assert_allclose(r, jconfig.rectify(imgf, want[side]),
                                   atol=1e-4, rtol=0)


def test_rectify_border_and_colour_equal_cv2():
    """Maps that leave the image on every side: taps outside read 0, as
    cv2's constant border; a three-channel image is sampled per channel."""
    rng = np.random.default_rng(8)
    u, v = np.meshgrid(np.linspace(-3.3, 40.7, 37, dtype=np.float32),
                       np.linspace(-2.1, 30.2, 29, dtype=np.float32))
    mx = u + rng.normal(0, 0.4, u.shape).astype(np.float32)
    my = v + rng.normal(0, 0.4, v.shape).astype(np.float32)
    for img in (rng.integers(0, 256, (28, 36)).astype(np.uint8),
                rng.integers(0, 256, (28, 36, 3)).astype(np.uint8)):
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
        np.testing.assert_array_equal(config.rectify(img, (mx, my)), want)
        f = img.astype(np.float32) / 7
        np.testing.assert_allclose(config.rectify(f, (mx, my)),
                                   cv2.remap(f, mx, my, cv2.INTER_LINEAR),
                                   atol=1e-4, rtol=0)
