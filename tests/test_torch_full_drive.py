"""FULL on the port alone, from raw images to the three exports (the
reference's tests/test_system_chunked.py FULL drive, on the CPU): line
mode online with the keyframe images kept, then shutdown's offline dense
phase. The semi-dense cloud must be non-empty; the 3D segments and the
mesh are written exactly when the phase produced some (on this arc the
reference produces none, tests/test_torch_full.py)."""

import os

import torch_parity  # noqa: F401  (one torch thread per test worker)
from test_torch_full import arc, port_config

from eao_slam_torch.system import System


def test_full_from_raw_images_to_the_three_exports(tmp_path):
    """(b) The port alone: FULL from raw images (line mode online, the
    keyframe images kept), then shutdown's dense phase and the three
    exports. The first 32 frames of the arc: the bootstrap, three chunks
    and a tail chunk that shutdown flushes."""
    ts, _, images, boxes = arc()
    n = 32
    sysm = System(port_config(), chunk=8, device="cpu")
    for k in range(n):
        sysm.track_monocular(images[k], float(ts[k]), boxes=boxes[k])
    res = sysm.shutdown()
    assert sysm.tracker.state == 2
    assert len(sysm.frame_trajectory()[0]) >= 0.8 * n
    assert res is not None and len(sysm._kf_images) >= 4
    assert set(sysm._semidense_slots) <= set(sysm._kf_images)
    counts = [sysm.save_semidense_obj(str(tmp_path / "sd.obj")),
              sysm.save_lines_obj(str(tmp_path / "lines.obj")),
              sysm.save_mesh_obj(str(tmp_path / "mesh.obj"))]
    assert counts[0] > 0 and os.path.getsize(tmp_path / "sd.obj") > 0
    assert counts[1:] == [len(sysm._lines3d), len(sysm._mesh_tris)]
    for count, name in zip(counts[1:], ("lines.obj", "mesh.obj")):
        assert (tmp_path / name).exists() == (count > 0)
