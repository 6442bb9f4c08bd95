"""The port and chip_smoke.py import neither jax, flax nor orbslam3_tpu,
nor OpenCV, PIL, imageio or PyYAML.

The machine with the card has no jax and no OpenCV; the test process here
imports jax
for every test (conftest.py), so a stray import would pass unnoticed. A
fresh interpreter blocks those names with a meta-path finder and imports
every module of the port and chip_smoke.py; an `ast` scan of the sources
catches imports on paths that importing does not run."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "flax", "orbslam3_tpu", "cv2", "PIL", "imageio", "yaml")
# the modules of the monocular SLAM slice
SLICE_B = ("engine.system", "engine.tracking", "engine.local_mapping", "opt.ba",
           "opt.pose_gn", "slam_map.map_state", "slam_map.atlas", "vision.twoview",
           "vision.triangulate", "vision.matcher", "utils.timing", "utils.verbose",
           "utils.synth", "datasets.render", "evaluation", "convert")
# the modules of the mono-inertial slice
SLICE_D = ("imu.preintegration", "imu.init", "opt.inertial", "opt.pose_inertial")
# the modules of the stereo / RGB-D slice
SLICE_C = ("vision.stereo", "vision.rectify", "config")
# the modules of the place-recognition / loop-closing slice
SLICE_E = ("place", "place.vocab", "place.database", "vision.pnp", "vision.sim3",
           "opt.pose_graph", "engine.global_ba", "engine.loop_closing")
# persistence, the edge server and its app, asynchronous mapping
SLICE_FH = ("slam_map.serialize", "engine.async_engine", "native", "edge", "edge.wire",
            "edge.acoustic", "edge.server", "edge.client_sim", "apps", "apps.edge_server")
# the distributed back end and its two-process app
SLICE_G = ("distributed", "distributed.map_blocks", "distributed.host_exchange",
           "distributed.mesh", "distributed.sharded_ba", "distributed.multihost",
           "apps.multihost")
# the dataset runners: the PNG codec, loaders, writers and the ten apps
SLICE_I = ("datasets", "datasets.imageio", "datasets.euroc", "datasets.kitti",
           "datasets.tum_rgbd", "datasets.synth_euroc", "apps.common", "apps.run_euroc",
           "apps.run_rgbd", "apps.run_kitti", "apps.run_pixel", "apps.run_synth",
           "apps.eval_ate", "apps.build_vocab", "apps.process_imu", "apps.opt_analy",
           "apps.draw_traj")

_CHILD = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = {blocked!r}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import orbslam3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(orbslam3_tpu_torch.__path__,
                                               "orbslam3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert not [n for n in sys.modules if n.split(".")[0] in BLOCKED]
print(" ".join(names))
"""


def _sources():
    sources = sorted((ROOT / "orbslam3_tpu_torch").rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "profile_frontend.py")]
    for app in ("edge_server.py", "multihost.py", "run_euroc.py", "draw_traj.py"):
        assert ROOT / "orbslam3_tpu_torch" / "apps" / app in sources
    assert (ROOT / "orbslam3_tpu_torch" / "distributed" / "sharded_ba.py") in sources
    return sources


def test_port_imports_with_jax_blocked():
    code = _CHILD.format(blocked=BLOCKED, smoke=str(ROOT / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 85  # every module of slices A-I
    assert {f"orbslam3_tpu_torch.{m}"
            for m in SLICE_B + SLICE_C + SLICE_D + SLICE_E + SLICE_FH + SLICE_G + SLICE_I
            } <= imported


def test_no_jax_import_in_sources():
    offenders = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in BLOCKED]
    assert not offenders, offenders
