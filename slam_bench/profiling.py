"""The benchmark's yardstick for the device: the profiler session, the
card's published and clock-derived rates, and each hand-written kernel's
least time at the cells' shapes.

Frozen copies from ``chip_smoke.py`` at commit d23e9c2: ``profiled``'s
session over the card's activity alone (``profiled_session``; a slice
whose session saw no operation fails its run instead of profiling again,
since its frames are gone), ``int_rates``, ``bound_ms`` (here in seconds:
``bound_s``),
``KERNEL_SYMBOLS`` and phase 3's count of each kernel's bytes and
operations (``kernel_phase``, ``frontend_kernel_check``), written here
as functions of the frame size and the ORB settings instead of a test
case's arrays. Where phase 3 counts work that depends on the data (the
pixels that the patch windows cover, the pairs that pass the windowed
search's gates), these count the least such work, so a share computed
from them is never above the kernel's true share.
"""
from __future__ import annotations

import subprocess

import numpy as np

# the H100 SXM's published peaks (NVIDIA H100 datasheet)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12       # float32 outside the tensor cores
# issue rates per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput)
INT32_PER_SM_CLK = 64
POPC_PER_SM_CLK = 16

# the port's kernels as the profiler names them
KERNEL_SYMBOLS = {"cell_topk": "cell_topk_levels_kernel",
                  "gather_patches": "gather_patches_levels_kernel",
                  "hamming_best2_windowed": "best2_kernel<true>",
                  "hamming_best2": "best2_kernel<false>",
                  "dense_frontend": "dense_frontend_kernel"}

# dense_frontend's operations a pixel: FAST's 16 differences and two
# 9-arc min/max trees (75 + 91), the 3x3 NMS (27), the moments (176) and
# the blur's taps (6) (chip_smoke.FRONTEND_OPS_PER_PIXEL)
FRONTEND_OPS_PER_PIXEL = (75 + 91) + 27 + 176 + 6
PATCH_W = 37          # rBRIEF's blurred window (brief.PATCH_W)


def int_rates(device_index: int = 0) -> dict:
    """The card's 32-bit integer and __popc rates (operations a second):
    its SM count times its maximum SM clock times the per-SM issue rates."""
    import torch
    smi = subprocess.run(["nvidia-smi", "-i", str(device_index),
                          "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=30)
    sm_hz = float(smi.stdout.split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return dict(sms=sms, sm_clock_hz=sm_hz,
                int32_ops_per_s=sms * sm_hz * INT32_PER_SM_CLK,
                popc_per_s=sms * sm_hz * POPC_PER_SM_CLK)


def bound_s(n_bytes, n_ops=0, n_int=0, n_popc=0, rates=None):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    memory rate and of each kind of operation over its own rate (float32
    n_ops on the CUDA cores, n_int 32-bit integer operations and n_popc
    popcounts at ``int_rates``)."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_o = n_ops / CUDA_CORE_OPS_PER_S
    if n_int or n_popc:
        t_o = max(t_o, n_int / rates["int32_ops_per_s"],
                  n_popc / rates["popc_per_s"])
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def level_shapes(h: int, w: int, n_levels: int, scale: float,
                 multiple: int = 8) -> list:
    """Each pyramid level's (h, w), rounded up to ``multiple`` (the port's
    ``pyramid.level_shapes``)."""
    out = []
    for lv in range(n_levels):
        lh = int(round(h / scale ** lv))
        lw = int(round(w / scale ** lv))
        out.append((-(-lh // multiple) * multiple, -(-lw // multiple) * multiple))
    return out


def content_dims(h: int, w: int, n_levels: int, scale: float) -> list:
    return [(int(round(h / scale ** lv)), int(round(w / scale ** lv)))
            for lv in range(n_levels)]


def frontend_bound(h: int, w: int, n_levels: int, scale: float):
    """One image's launch of dense_frontend over its levels: read each
    pixel once and write four maps; FRONTEND_OPS_PER_PIXEL a pixel."""
    n_px = sum(a * b for a, b in level_shapes(h, w, n_levels, scale))
    return bound_s(n_px * 20, n_px * FRONTEND_OPS_PER_PIXEL)


def cell_topk_bound(h: int, w: int, n_levels: int, scale: float,
                    margin: int = 16, cell: int = 32, k: int = 8):
    """One image's launch of cell_topk over its levels: read the pixels
    inside the border masks (one compare each) and write each cell's top-k
    (value and index)."""
    shapes = level_shapes(h, w, n_levels, scale)
    contents = content_dims(h, w, n_levels, scale)
    n_in = sum(max(0, min(lh, ch - margin) - margin)
               * max(0, min(lw, cw - margin) - margin)
               for (lh, lw), (ch, cw) in zip(shapes, contents))
    n_rows = sum(-(-lh // cell) * -(-lw // cell) for lh, lw in shapes)
    return bound_s(n_in * 4 + n_rows * k * 8, n_in)


def gather_patches_bound(n_feat: int):
    """One launch of gather_patches for n_feat keypoints: their corners and
    levels (12 bytes each) read and every 37x37 window written; the pixels
    the windows cover are read at least once, and this counts none of them
    (the least work)."""
    return bound_s(n_feat * 12 + n_feat * PATCH_W * PATCH_W * 4, 0)


def windowed_bound(Q: int, K: int, rates: dict):
    """One call of the windowed best-2 search, Q queries against K targets:
    each query's descriptor, position, level, radius, level window, mask
    and results, and each target's descriptor, position, level and mask
    read once; 8 gate operations a pair (the pairs that pass the gates,
    whose XOR, popcount and compares depend on the data, counted as
    none)."""
    nbytes = Q * (32 + 8 + 4 * 4 + 1 + 12) + K * (32 + 8 + 4 + 1)
    return bound_s(nbytes, n_int=8 * Q * K, rates=rates)


def profiled_session(activities):
    """A started torch.profiler session over ``activities`` (stop it with
    ``.stop()``)."""
    from torch.profiler import profile
    prof = profile(activities=activities)
    prof.start()
    return prof


def device_events(prof, device_type: str = "cuda") -> list:
    """[(name, start_ns, duration_ns)] of the operations that ran on the
    device in a stopped session (on the card: kernels, copies and fills),
    oldest first."""
    from torch.autograd import DeviceType
    want = DeviceType.CUDA if device_type == "cuda" else DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        if hasattr(e, "start_ns"):
            s, d = int(e.start_ns()), int(e.duration_ns())
        else:
            s, d = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append((e.name(), s, d))
    out.sort(key=lambda x: x[1])
    return out


def busy_union(events) -> tuple:
    """(busy ns, [(gap start ns, gap end ns)]) of events sorted by start:
    the union of their intervals and the idle gaps between them."""
    busy = 0
    gaps = []
    cur_s = cur_e = None
    for _, s, d in events:
        e = s + d
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
