"""A cell's inputs: the rendered frames of its configuration's scene and
camera trajectory (cached once per checkout) and the detector boxes. The
frames are fed in the trajectory's order, each once.

Rendering costs about a second a frame on one host core, s x s times that
at the configuration's ``supersample`` s, so the frames are rendered once
per checkout, by a pool of processes at a lower priority,
into ``benchmark/cache/``, under a name keyed by a hash of the scene, the
camera, the trajectory and the renderer's source. Later runs load them.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import NamedTuple

import numpy as np

from harness import synthetic
from harness.spec import BENCH_DIR

CACHE_DIR = os.path.join(BENCH_DIR, "cache")

_SCENE = None     # the render pool's scene (set by the pool initializer)


class Camera(NamedTuple):
    """The renderer's and the box projector's view of a camera."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


class Inputs(NamedTuple):
    images: np.ndarray        # [N, H, W] uint8, the trajectory's frames in order
    gt: np.ndarray            # [N, 3, 4] true camera-from-world poses
    boxes: tuple              # (boxes, class, score, valid), each [N, B, ...], or None
    scene: synthetic.Scene
    fps: float


def camera(config: dict) -> Camera:
    c = config["camera"]
    return Camera(c["fx"], c["fy"], c["cx"], c["cy"], int(c["width"]), int(c["height"]))


def make_scene(config: dict) -> synthetic.Scene:
    s = dict(config["scene"])
    s.pop("supersample", None)
    for k in ("obj_z_range", "obj_size_range", "face_shade"):
        if k in s:
            s[k] = tuple(s[k])
    return synthetic.make_room_scene(**s)


def make_trajectory(config: dict):
    """(timestamps, true poses) of the configuration's camera sweep."""
    return synthetic.make_sweep_trajectory(**config["trajectory"],
                                           fps=float(config["camera"]["fps"]))


def _cache_key(config: dict, cam: Camera) -> str:
    with open(synthetic.__file__, "rb") as f:
        renderer = hashlib.sha256(f.read()).hexdigest()
    blob = json.dumps({"scene": config["scene"], "trajectory": config["trajectory"],
                       "camera": cam._asdict(), "renderer": renderer}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def _init_pool(scene) -> None:
    global _SCENE
    _SCENE = scene
    os.nice(10)


def _render(task):
    cam, T_cw, supersample = task
    return synthetic.render_image(_SCENE, cam, T_cw, supersample=supersample)


def render(scene, cam: Camera, gt: np.ndarray, workers: int, supersample: int = 1) -> np.ndarray:
    """Every pose's frame; ``supersample`` s averages s x s rays a pixel, so
    that texture finer than a pixel does not alias into corners that move
    from frame to frame."""
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init_pool, initargs=(scene,)) as pool:
        return np.stack(list(pool.map(_render, [(cam, T, supersample) for T in gt])))


def load(config: dict, max_boxes: int, workers: int = None,
         cache_dir: str = CACHE_DIR) -> Inputs:
    """The cell's frames (from the cache, or rendered into it), poses and,
    where ``max_boxes`` > 0, the detector boxes of every frame in that many
    slots."""
    cam = camera(config)
    scene = make_scene(config)
    _, gt = make_trajectory(config)
    path = os.path.join(cache_dir, f"frames-{_cache_key(config, cam)}.npy")
    if os.path.exists(path):
        images = np.load(path)
    else:
        os.makedirs(cache_dir, exist_ok=True)
        images = render(scene, cam, gt, workers or min(8, os.cpu_count() or 1),
                        int(config["scene"].get("supersample", 1)))
        tmp = f"{path}.{os.getpid()}.tmp.npy"
        np.save(tmp, images)
        os.replace(tmp, path)
    boxes = None
    if max_boxes > 0:
        per = [synthetic.project_boxes(scene, cam, T, max_boxes)
               for T in gt]
        boxes = tuple(np.stack([b[i] for b in per]) for i in range(4))
    return Inputs(images, gt, boxes, scene, float(config["camera"]["fps"]))
