"""Small synthetic datasets on disk for the port's entry point tests, in
the reference layouts that ``tests/test_examples_cli.py`` writes (EuRoC
mav0 with imu0, TUM RGB-D, KITTI odometry), at 376x240: frames ray-cast by
the port's ``synth_render`` and written by its PNG writer.

At this size the monocular two-view initialisation does not reach the
full-size default of 100 matches, so ``small_init`` lowers
``min_init_matches`` to 50 in the Systems the entry points build, as the
port's other small tests do. The monocular cases feed the first 12 frames
of a 30-frame orbit of world seed 1, whose spacing gives the initialisation
its parallax within 12 frames, also on the CLAHE-equalised frames of
the TUM-VI entry points (most other worlds do not initialise there at this
size).
"""
import contextlib
import dataclasses
import functools

import numpy as np

from orb_slam3_detailed_comments_tpu_torch.models import cameras
from orb_slam3_detailed_comments_tpu_torch.pipeline import system
from orb_slam3_detailed_comments_tpu_torch.utils import png, synth_render

W, H, FX, FY = 376, 240, 229.0, 228.5
CAM = cameras.pinhole(FX, FY, W / 2, H / 2, W, H)
N = 12
YAML = f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {FX}
Camera1.fy: {FY}
Camera1.cx: {W / 2}
Camera1.cy: {H / 2}
Camera.width: {W}
Camera.height: {H}
Camera.fps: 20
{{extra}}ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
IMU_YAML = ("IMU.NoiseGyro: 1.7e-4\nIMU.NoiseAcc: 2.0e-3\n"
            "IMU.GyroWalk: 1.9e-5\nIMU.AccWalk: 3.0e-3\n"
            "IMU.Frequency: 200\n")


@contextlib.contextmanager
def small_init(min_init_matches: int = 50):
    """Systems built meanwhile take min_init_matches (see the module)."""
    orig = system.TrackingConfig

    @functools.wraps(orig)
    def make(*a, **kw):
        return dataclasses.replace(orig(*a, **kw),
                                   min_init_matches=min_init_matches)

    system.TrackingConfig = make
    try:
        yield
    finally:
        system.TrackingConfig = orig


def orbit(world_seed=1, n=N, n_orbit=30):
    planes = synth_render.default_world(np.random.default_rng(world_seed))
    R, t = synth_render.orbit_trajectory(n_orbit)
    return planes, R[:n], t[:n]


def _u8(img):
    return np.clip(np.asarray(img), 0, 255).astype(np.uint8)


def frame(planes, R, t):
    return synth_render.render_frame_raycast(CAM, planes, R, t)[0]


def write_euroc(root, planes, R, t, ts, stereo=False, baseline=0.11):
    """mav0/cam0 (and cam1) data/<ns>.png at times ts (s), no data.csv."""
    for cam_name in ("cam0", "cam1") if stereo else ("cam0",):
        (root / "mav0" / cam_name / "data").mkdir(parents=True)
    for i in range(len(R)):
        ns = int(round(1e9 * ts[i]))
        if stereo:
            left, right = synth_render.render_stereo_pair(CAM, planes, R[i],
                                                          t[i], baseline)
            png.write_png(str(root / "mav0" / "cam1" / "data" / f"{ns}.png"),
                          _u8(right))
        else:
            left = frame(planes, R[i], t[i])
        png.write_png(str(root / "mav0" / "cam0" / "data" / f"{ns}.png"),
                      _u8(left))


def write_imu(root, windows, t0=1.0):
    d = root / "mav0" / "imu0"
    d.mkdir(parents=True)
    with open(d / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for w in windows:
            if w is None:
                continue
            acc, gyro, tm = (np.asarray(w[0]), np.asarray(w[1]),
                             np.asarray(w[2]))
            for j in range(len(tm)):
                f.write(f"{int(round(1e9 * (t0 + tm[j])))},"
                        f"{gyro[j, 0]},{gyro[j, 1]},{gyro[j, 2]},"
                        f"{acc[j, 0]},{acc[j, 1]},{acc[j, 2]}\n")


def write_tum(root, planes, R, t):
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rgb_l, d_l = [], []
    for i in range(len(R)):
        img, X, hit = synth_render.render_frame_raycast(CAM, planes, R[i],
                                                        t[i])
        depth = synth_render.camera_depth(R[i], t[i], X, hit)
        ts = 1.0 + i * 0.05
        png.write_png(str(root / "rgb" / f"{ts:.6f}.png"), _u8(img))
        png.write_png(str(root / "depth" / f"{ts:.6f}.png"),
                      np.clip(depth * 5000.0, 0, 65535).astype(np.uint16))
        rgb_l.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        d_l.append(f"{ts:.6f} depth/{ts:.6f}.png")
    (root / "rgb.txt").write_text("# ts f\n" + "\n".join(rgb_l) + "\n")
    (root / "depth.txt").write_text("# ts f\n" + "\n".join(d_l) + "\n")


def write_kitti(root, planes, R, t, stereo=False, baseline=0.12):
    (root / "image_0").mkdir()
    (root / "image_1").mkdir()
    for i in range(len(R)):
        if stereo:
            left, right = synth_render.render_stereo_pair(CAM, planes, R[i],
                                                          t[i], baseline)
        else:
            left = right = frame(planes, R[i], t[i])
        png.write_png(str(root / "image_0" / f"{i:06d}.png"), _u8(left))
        png.write_png(str(root / "image_1" / f"{i:06d}.png"), _u8(right))
    np.savetxt(root / "times.txt", np.arange(len(R)) * 0.05)


def rectification_yaml(baseline: float) -> str:
    """Legacy LEFT.* / RIGHT.* blocks of an identity rig at CAM (the
    rendered pinhole pairs go through the remap unchanged)."""
    bf = FX * baseline
    K = f"[{FX}, 0.0, {W / 2}, 0.0, {FY}, {H / 2}, 0.0, 0.0, 1.0]"
    ident = "[1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]"
    zeros5 = "[0.0, 0.0, 0.0, 0.0, 0.0]"
    mat = "!!opencv-matrix\n  rows: {r}\n  cols: {c}\n  dt: d\n  data: {d}\n"
    out = f"Camera.bf: {bf}\n"
    for side, tx in (("LEFT", 0.0), ("RIGHT", -bf)):
        P = (f"[{FX}, 0.0, {W / 2}, {tx}, 0.0, {FY}, {H / 2}, 0.0, "
             f"0.0, 0.0, 1.0, 0.0]")
        out += (f"{side}.width: {W}\n{side}.height: {H}\n"
                f"{side}.K: {mat.format(r=3, c=3, d=K)}"
                f"{side}.D: {mat.format(r=1, c=5, d=zeros5)}"
                f"{side}.R: {mat.format(r=3, c=3, d=ident)}"
                f"{side}.P: {mat.format(r=3, c=4, d=P)}")
    return out
