"""The port stands alone: no JAX, no reference package, the card by default,
the default configuration builds, the object-layer flags construct (with
and without line-alignment yaw, and FULL with its offline dense phase),
and ``chunked=False`` builds the interactive MonoTracker."""

import subprocess
import sys
import os

import pytest
import torch

from eao_slam_torch.config import CapacityConfig, DemoFlag, TrackingConfig, tum3_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import eao_slam_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(eao_slam_torch.__path__, "
        "'eao_slam_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "need = {'eao_slam_torch.io.tum', 'eao_slam_torch.objects.association', "
        "'eao_slam_torch.objects.resolve', 'eao_slam_torch.objects.merge', "
        "'eao_slam_torch.objects.iforest', 'eao_slam_torch.objects.stats', "
        "'eao_slam_torch.objects.boxes', 'eao_slam_torch.objects.state', "
        "'eao_slam_torch.objects.yaw', 'eao_slam_torch.ops.lines', "
        "'eao_slam_torch.io.trajectory', 'eao_slam_torch.dense.semidense', "
        "'eao_slam_torch.dense.lines3d', 'eao_slam_torch.dense.mesh', "
        "'eao_slam_torch.evaluation', 'eao_slam_torch.ops.bow', "
        "'eao_slam_torch.runtime.keyframe_db', 'eao_slam_torch.runtime.tracker', "
        "'eao_slam_torch.objects.cuboid_proposal', 'eao_slam_torch.cli', "
        "'eao_slam_torch.io.kitti', 'eao_slam_torch.io.euroc', "
        "'eao_slam_torch.io.native_loader', 'eao_slam_torch.utils.profiling', "
        "'eao_slam_torch.viz.raster', 'eao_slam_torch.viz.frame_drawer', "
        "'eao_slam_torch.viz.map_drawer', 'eao_slam_torch.viz.viewer', "
        "'eao_slam_torch.parallel', 'eao_slam_torch.parallel.distributed', "
        "'eao_slam_torch.parallel.dist_ba', 'eao_slam_torch.parallel.dist_ba2', "
        "'eao_slam_torch.parallel.frames', 'eao_slam_torch.parallel.multi_seq'}\n"
        "assert need <= set(names), need - set(names)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('eao_slam_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def _cfg(**kw):
    return tum3_config().replace(
        capacity=CapacityConfig(max_keyframes=8, max_points=64, max_features=32,
                                local_ba_points=32), **kw)


def test_entry_points_need_a_card_or_an_explicit_cpu():
    from eao_slam_torch.system import System

    for chunked in (True, False):
        if torch.cuda.is_available():
            assert System(_cfg(), chunked=chunked).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                System(_cfg(), chunked=chunked)
        assert System(_cfg(), chunked=chunked, device="cpu").device.type == "cpu"
    # the command-line drivers build their System first: without a card and
    # without device="cpu" they raise before reading anything; with a card
    # they go on to the (missing) sequence
    from eao_slam_torch import cli

    missing = os.path.join(REPO, "no_such_sequence")
    drivers = [lambda: cli.run_mono_tum("None", missing),
               lambda: cli.run_mono_kitti("None", missing, 0),
               lambda: cli.run_mono_euroc("None", missing)]
    for run in drivers:
        with pytest.raises(FileNotFoundError if torch.cuda.is_available() else RuntimeError,
                           match=None if torch.cuda.is_available() else "device='cpu'"):
            run()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.run_demo("None", 2)


def test_default_configuration_builds():
    """``System()`` with the default TrackingConfig (loop closing on, the
    reference's default) builds, with its loop closer."""
    from eao_slam_torch.system import System

    assert TrackingConfig().enable_loop_closing
    sysm = System(device="cpu")
    assert sysm.tracker.loop_closer is not None
    assert System(_cfg(), device="cpu").tracker.loop_closer is not None
    off = _cfg().replace(tracking=TrackingConfig(enable_loop_closing=False))
    assert System(off, device="cpu").tracker.loop_closer is None


@pytest.mark.parametrize("case", ["LineAndiForest", "Full", "per_frame"])
def test_unported_modes_raise(case):
    """No mode is refused any more: the interactive tracker
    (chunked=False) builds a MonoTracker in geometry mode and in FULL (its
    loop closer, its object updater in FULL, no vocabulary until the
    first keyframes); LineAndiForest and FULL construct the chunked path."""
    from eao_slam_torch.runtime.tracker import MonoTracker
    from eao_slam_torch.system import System

    if case == "per_frame":
        for flag in (DemoFlag.NONE, DemoFlag.FULL):
            sysm = System(_cfg(flag=flag), chunked=False, device="cpu")
            assert isinstance(sysm.tracker, MonoTracker) and not sysm.chunked
            assert sysm.tracker.loop_closer is not None and sysm.tracker.vocab is None
            assert (sysm.tracker.obj_updater is not None) == (flag == DemoFlag.FULL)
            assert sysm.shutdown() is None and sysm.current_pose() is None
    else:
        for sysm in (System(_cfg(flag=DemoFlag(case)), device="cpu"),
                     System(flag=case, device="cpu")):
            assert sysm.cfg.flag.use_yaw_lines
            assert sysm.cfg.flag.semidense_enabled == (case == "Full")
            assert sysm.shutdown() is None         # nothing tracked: no dense phase


@pytest.mark.parametrize("flag", ["EAO", "iForest", "NA", "IoU", "NP"])
def test_object_flags_construct(flag):
    """The object-layer flags without lines construct the chunked path, by
    configuration or by the flag argument, with their cascade stages."""
    from eao_slam_torch.system import System

    for sysm in (System(_cfg(flag=DemoFlag(flag)), device="cpu"), System(flag=flag, device="cpu")):
        assert sysm.cfg.flag.objects_enabled and not sysm.cfg.flag.use_yaw_lines
        assert sysm.tracker.obj_table is None          # the table arms with the tracker
    f = DemoFlag(flag)
    assert (f.use_iou, f.use_nonparam, f.use_ttest) == {
        "EAO": (True, True, True), "iForest": (True, True, True), "NA": (False, False, False),
        "IoU": (True, False, False), "NP": (False, True, False)}[flag]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py alone in a directory cannot import the port and exits
    non-zero without printing a result line."""
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_config_matches_reference_fields_and_defaults():
    """Every field the port's config keeps has the reference's name and
    default, and the flags are the reference's."""
    import dataclasses

    from eao_slam_torch import config as tc
    from eao_slam_tpu import config as jc

    for name in ("OrbConfig", "MatcherConfig", "TrackingConfig", "ObjectConfig",
                 "MappingConfig", "SemiDenseConfig", "CapacityConfig"):
        ours = {f.name: f.default for f in dataclasses.fields(getattr(tc, name))}
        ref = {f.name: f.default for f in dataclasses.fields(getattr(jc, name))}
        for field, default in ours.items():
            assert ref[field] == default, (name, field)
    ref_sys = {f.name: f.default for f in dataclasses.fields(jc.SystemConfig)}
    for field in ("seed", "vocab_path", "bow_bootstrap_kfs", "use_bow"):
        assert getattr(tc.SystemConfig(), field) == ref_sys[field], field
    assert {"use_cubeslam", "per_frame_iforest"} <= {
        f.name for f in dataclasses.fields(tc.ObjectConfig)}
    assert {f.value for f in tc.DemoFlag} == {f.value for f in jc.DemoFlag}
    for f in tc.DemoFlag:
        j = jc.DemoFlag(f.value)
        for prop in ("objects_enabled", "use_iou", "use_nonparam", "use_ttest", "use_yaw_lines",
                     "semidense_enabled"):
            assert getattr(f, prop) == getattr(j, prop), (f, prop)
    assert tc.tum3_config().seed == jc.tum3_config().seed
    assert tc.tum3_config().camera == tuple(jc.tum3_config().camera)


def test_mesh_auto_without_a_process_group_is_one_device():
    """System(mesh="auto") with no process group (one process) arms no
    mesh, as the reference's does on one device: the chunked tracker has
    no BA mesh and ``ba_solver`` is None; a one-rank mesh is the same,
    and without EAO_COORDINATOR initialize_from_env starts nothing."""
    from eao_slam_torch.parallel.distributed import world
    from eao_slam_torch.parallel.frames import make_frame_mesh
    from eao_slam_torch.runtime.scan_tracker import ChunkedTracker
    from eao_slam_torch.system import System

    assert world() == (0, 1)
    sysm = System(_cfg(), device="cpu", mesh="auto")
    assert sysm.tracker.mesh is None and sysm.tracker.ba_solver is None
    assert ChunkedTracker(_cfg(), device="cpu", mesh=make_frame_mesh("cpu")).ba_solver is None
    env = {k: v for k, v in os.environ.items() if not k.startswith("EAO_")}
    code = ("from eao_slam_torch.parallel.distributed import initialize_from_env\n"
            "assert initialize_from_env(device='cpu') is False\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(env, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_initialize_from_env_raises_on_a_group_that_cannot_form(tmp_path):
    """EAO_PROCESS_ID outside EAO_NUM_PROCESSES raises; a group whose other
    ranks never come raises at its timeout. Nothing falls back to one
    process."""
    code = ("import os\n"
            "from eao_slam_torch.parallel.distributed import initialize_from_env\n"
            "try:\n"
            "    initialize_from_env(device='cpu', timeout_s=float(os.environ['T']))\n"
            "except Exception as exc:\n"
            "    print('RAISED', type(exc).__name__)\n")
    base = {k: v for k, v in os.environ.items() if not k.startswith("EAO_")}
    for extra, t_s in (({"EAO_NUM_PROCESSES": "2", "EAO_PROCESS_ID": "2"}, "5"),
                       ({"EAO_NUM_PROCESSES": "2", "EAO_PROCESS_ID": "0"}, "3")):
        env = dict(base, PYTHONPATH=REPO, T=t_s,
                   EAO_COORDINATOR=f"file://{tmp_path}/store_{extra['EAO_PROCESS_ID']}", **extra)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert "RAISED" in out.stdout, out.stdout + out.stderr
