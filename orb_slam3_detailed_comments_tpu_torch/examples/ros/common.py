"""Shared launcher for the ROS nodes (reference: Examples/ROS/ORB_SLAM3),
the counterpart of the JAX package's ``examples/ros/common.py``.

    python -m orb_slam3_detailed_comments_tpu_torch.examples.ros.ros_<node>
        <settings.yaml> [dataset_dir] [--equalize] [--rectify] [--device cpu]

With rospy installed (a real ROS environment) and no dataset directory the
node subscribes to live topics. Otherwise a dataset directory is replayed
through the same node and topic path via LocalTransport, so the whole
message flow (buffers, pairing, IMU sync) runs end to end: the EuRoC
layout, or for the RGB-D node a TUM RGB-D directory (rgb.txt, depth.txt;
the JAX package's launcher replays the EuRoC layout for it too, whose grey
images never reach the RGB-D node's topics). The trajectory goes to
``trajectory_ros_<node>.txt`` in the working directory.
"""

import numpy as np

from ...pipeline import system as S
from ...ros import nodes
from ...ros import transport as T
from ...utils import config, datasets
from .. import runner


def build(sensor_name: str, settings_path: str, equalize: bool = False,
          rectify: bool = False, device=None):
    """The System and the node of one launcher, from a settings file."""
    s = config.load_settings(settings_path)
    maps = None
    cam_override = {}
    if rectify:
        rect = config.stereo_rectify_maps(s)
        if rect is not None:
            m_l, m_r, cam_rect, baseline = rect
            maps = (m_l, m_r)
            cam_override = dict(camera=cam_rect,
                                baseline=baseline)

    sensors = {
        "mono": (S.MONOCULAR, lambda sl: nodes.MonoNode(sl, equalize)),
        "mono_inertial": (S.IMU_MONOCULAR,
                          lambda sl: nodes.MonoInertialNode(sl, equalize)),
        "stereo": (S.STEREO,
                   lambda sl: nodes.StereoNode(sl, equalize, maps)),
        "stereo_inertial": (S.IMU_STEREO,
                            lambda sl: nodes.StereoInertialNode(
                                sl, equalize, maps)),
        "rgbd": (S.RGBD, lambda sl: nodes.RGBDNode(
            sl, depth_factor=s.depth_map_factor or 5000.0)),
        "mono_ar": (S.MONOCULAR, lambda sl: nodes.MonoARNode(sl)),
    }
    sensor, make = sensors[sensor_name]
    slam = S.System.from_settings(s, sensor, device=device, **cam_override)
    return slam, make(slam), s


def main(sensor_name: str, argv):
    argv, device = runner.split_device(argv)
    if len(argv) < 1:
        print(f"usage: python -m orb_slam3_detailed_comments_tpu_torch."
              f"examples.ros.ros_{sensor_name} <settings.yaml> "
              f"[dataset_dir] [--equalize] [--rectify] [--device cpu]")
        return 1
    flags = [a for a in argv if a.startswith("--")]
    pos = [a for a in argv if not a.startswith("--")]
    settings = pos[0]
    dataset = pos[1] if len(pos) > 1 else None
    slam, node, s = build(sensor_name, settings,
                          equalize="--equalize" in flags,
                          rectify="--rectify" in flags, device=device)

    try:
        import rospy  # noqa: F401
        have_ros = dataset is None
    except ImportError:
        have_ros = False

    if have_ros:  # pragma: no cover - needs a ROS master
        tr = T.RospyTransport(f"orb_slam3_{sensor_name}")
        node.attach(tr)
        node.run(tr)
        slam.save_trajectory_tum(f"trajectory_{sensor_name}.txt")
        slam.shutdown()
        return 0

    if dataset is None:
        print("no ROS master and no dataset directory to replay; exiting")
        return 1

    # offline replay through the node's own topic path
    tr = T.LocalTransport()
    node.attach(tr)
    if sensor_name == "rgbd":
        _replay_tum_rgbd(dataset, node, tr, slam, s)
    else:
        _replay_euroc(dataset, sensor_name, node, tr, slam, s)
    while node.sync_once():
        pass
    out = f"trajectory_ros_{sensor_name}.txt"
    slam.save_trajectory_tum(out)
    print(f"poses published: {len(tr.published(node.POSE_TOPIC))}; saved {out}")
    slam.shutdown()
    return 0


def _replay_tum_rgbd(dataset, node, tr, slam, s):
    """A TUM RGB-D directory onto the RGB-D node's two topics: the grey
    image and the stored 16-bit depth, which the node scales."""
    from ...utils import png
    rgb_p, rgb_t, d_p, d_t = datasets.load_tum_rgbd(dataset)
    pairs = datasets.associate_rgbd(rgb_t, d_t)
    for i, (ri, di) in enumerate(pairs):
        img = config.resize_image(datasets.read_gray(rgb_p[ri]), s.resize_to)
        depth = png.imread_unchanged(d_p[di])
        tr.deliver("/camera/rgb/image_raw", T.ImageMsg(float(rgb_t[ri]), img))
        tr.deliver("/camera/depth_registered/image_raw",
                   T.ImageMsg(float(rgb_t[ri]), depth))
        node.sync_once()
        if i % 50 == 0:
            print(f"frame {i}/{len(pairs)} tracked={node.n_tracked} "
                  f"kf={slam.n_keyframes} pts={slam.n_map_points}")


def _replay_euroc(dataset, sensor_name, node, tr, slam, s):
    """A EuRoC directory onto the node's image (and IMU) topics."""
    paths_l, ts = datasets.load_euroc_images(dataset, cam="cam0")
    inertial = "inertial" in sensor_name
    stereo = "stereo" in sensor_name
    if stereo:
        paths_r, _ = datasets.load_euroc_images(dataset, cam="cam1")
    if inertial:
        imu_ts, gyro, acc = datasets.load_euroc_imu(dataset)
        first = int(np.searchsorted(ts, imu_ts[0]))
        paths_l, ts = paths_l[first:], ts[first:]
        if stereo:
            paths_r = paths_r[first:]
        ii = 0
    for i, t in enumerate(ts):
        if inertial:
            while ii < len(imu_ts) and imu_ts[ii] <= t + 1e-9:
                tr.deliver("/imu", T.ImuMsg(float(imu_ts[ii]),
                                            gyro[ii], acc[ii]))
                ii += 1
        img = config.resize_image(datasets.read_gray(paths_l[i]), s.resize_to)
        if stereo:
            img_r = config.resize_image(datasets.read_gray(paths_r[i]),
                                        s.resize_to)
            tr.deliver("/camera/left/image_raw", T.ImageMsg(float(t), img))
            tr.deliver("/camera/right/image_raw", T.ImageMsg(float(t), img_r))
        else:
            tr.deliver("/camera/image_raw", T.ImageMsg(float(t), img))
        node.sync_once()
        if i % 50 == 0:
            print(f"frame {i}/{len(ts)} tracked={node.n_tracked} "
                  f"kf={slam.n_keyframes} pts={slam.n_map_points}")
