"""The port never imports jax, nor anything of the JAX package: it must
import and score with both blocked, and no module of it may name either (the
machine the port runs on has no jax installed). What it needs from the JAX
package's jax-free modules it keeps as copies, held here to their originals."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "formula_vad_tpu_torch"
REFERENCE = REPO / "formula_vad_tpu"
# eval/denoise_quality.py is a port, not a copy: the JAX module scans its
# chunk step with jax.
COPIES = (
    ["config.py"]
    + [f"eval/{m}.py" for m in ("__init__", "evaluator", "formats", "report", "statistics")]
    + [f"io_/{m}.py" for m in ("__init__", "audio", "wav", "ogg", "flac", "aiff", "au", "caf", "native", "prefetch")]
    + ["apps/evaluator_cli.py"]
    + [f"utils/{m}.py" for m in ("uuid", "logging")]
)

# Nothing of JAX, its optimizer and checkpoint libraries, or the JAX package.
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "formula_vad_tpu")

BLOCKED_RUN = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["formula_vad_tpu"] = None  # and so does any import of the JAX package
sys.modules["optax"] = sys.modules["orbax"] = None  # nor the JAX trainer's optimizer and checkpointer
import numpy as np
import formula_vad_tpu_torch
names = [m.name for m in pkgutil.walk_packages(formula_vad_tpu_torch.__path__, "formula_vad_tpu_torch.")]
assert "formula_vad_tpu_torch.testing.tier_fuzz" in names, names
assert {"formula_vad_tpu_torch.train.nsnet2_train", "formula_vad_tpu_torch.apps.train"} <= set(names), names
assert {"formula_vad_tpu_torch.parallel.mesh", "formula_vad_tpu_torch.testing.distributed"} <= set(names), names
for name in names:
    importlib.import_module(name)
from formula_vad_tpu_torch.testing.synth import synth_stream
from formula_vad_tpu_torch.models.registry import load_denoiser
from formula_vad_tpu_torch.parallel.runner import BatchRunner
audio, _ = synth_stream(np.random.default_rng(0), 1.0)
(res,) = BatchRunner(load_denoiser("demo", device="cpu")).run(audio[None])
import os, tempfile
from formula_vad_tpu_torch.models.onnx_import import export_nsnet2_onnx
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "demo.onnx")
    with open(path, "wb") as f:
        f.write(export_nsnet2_onnx(load_denoiser("demo", device="cpu")))
    (imported,) = BatchRunner(load_denoiser(path, device="cpu")).run(audio[None])
(gated,) = BatchRunner(load_denoiser("spectral_gate", device="cpu")).run(audio[None])
assert imported.segments == res.segments
from formula_vad_tpu_torch.eval.denoise_quality import IdentityGains, pipeline_denoise
_, _, clean = synth_stream(np.random.default_rng(0), 1.0, components=True)
assert pipeline_denoise(IdentityGains(), clean, device="cpu").shape == (2, 48000)
from formula_vad_tpu_torch.config import PipelineConfig
from formula_vad_tpu_torch.pipeline.pipeline import AudioPipeline
pipe = AudioPipeline(PipelineConfig(), device="cpu")
for part in np.array_split(np.tile(audio, 2), 3, axis=1):
    pipe.push_samples(part)
assert pipe.total_write_count == 96000 and pipe.denoised_ring.total_written == 96000, pipe.denoised_ring.total_written
import io, json, tempfile
from formula_vad_tpu_torch.parallel.online import OnlineBatchServer
server = OnlineBatchServer(PipelineConfig(), 2, params=pipe.net, device="cpu")
server.push(np.stack([audio[:, :24000], audio[:, 24000:48000]]))
assert server.tick_stats()["ticks"] == 1
from formula_vad_tpu_torch.apps.multidaemon import MultiDaemon
with tempfile.TemporaryDirectory() as d:
    out = io.StringIO()
    MultiDaemon("M", d, ["x", "y"], "demo", stdout=out, state_dir=d + "/state", device="cpu").run(
        stdin=io.StringIO(json.dumps({"action": "stats"}) + "\n"))
    assert json.loads(out.getvalue())["streams"] == 2, out.getvalue()
from formula_vad_tpu_torch.apps import train
with tempfile.TemporaryDirectory() as d:
    args = ["--synthetic", "2", "--steps", "2", "--batch", "1", "--frames", "4", "--device", "cpu"]
    assert train.main(args + ["--out", d + "/w.onnx", "--ckpt-dir", d + "/ck", "--ckpt-every", "1"]) == 0
    assert train.main(args[:3] + ["3"] + args[4:] + ["--ckpt-dir", d + "/ck", "--out", d + "/w.npz"]) == 0
    assert train.main.last_run["start_step"] == 2 and len(train.main.last_run["losses"]) == 1
    load_denoiser(d + "/w.onnx", device="cpu")
    train.grid_devices = lambda dev: [dev] * 4  # the trainer's grid: --tp 2 on 2 x 2 CPU devices
    assert train.main(args + ["--tp", "2", "--out", d + "/g.npz"]) == 0
    assert train.main.last_run["grid"] == {"data": 2, "model": 2} and train.main.last_run["batch"] == 2
import torch
from formula_vad_tpu_torch.parallel import mesh
from formula_vad_tpu_torch.train import nsnet2_train
sharded = nsnet2_train.shard_params(nsnet2_train.trainable(load_denoiser("demo", device="cpu")),
                                    mesh.data_model_mesh(2, ["cpu"] * 4))
opt = torch.optim.Adam(sharded.parameters())
step = nsnet2_train.make_train_step(opt, sharded, sharded.mesh)
assert torch.isfinite(step(nsnet2_train.synth_batch(torch.Generator().manual_seed(0), 2, 4)))
(sharded,) = BatchRunner(load_denoiser("demo", device="cpu"), mesh=mesh.data_mesh(["cpu"] * 2)).run(audio[None])
assert sharded.segments == res.segments
import socket
from formula_vad_tpu_torch.testing import distributed
with socket.socket() as s, tempfile.TemporaryDirectory() as d:
    s.bind(("127.0.0.1", 0))
    os.environ.update(COORDINATOR_ADDRESS="127.0.0.1:%d" % s.getsockname()[1], NUM_PROCESSES="1", PROCESS_ID="0")
    s.close()
    assert distributed.main([d + "/w.json", "--device", "cpu"]) == 0
    assert json.load(open(d + "/w.json"))["mesh_size"] == 2
loaded = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
assert not loaded & {"jax", "formula_vad_tpu", "optax", "orbax"}, loaded
print("modules", len(names), "segments", len(res.segments))
"""


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    pkg = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def test_no_module_names_jax():
    # csrc/ holds CUDA sources and, once built, a git-ignored build directory.
    files = sorted(p for p in PACKAGE.rglob("*.py") if "csrc" not in p.relative_to(PACKAGE).parts)
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    assert {PACKAGE / "train" / "nsnet2_train.py", PACKAGE / "apps" / "train.py"} <= set(files)
    assert {PACKAGE / "parallel" / "mesh.py", PACKAGE / "testing" / "distributed.py"} <= set(files)
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


def test_chip_smoke_imports_only_the_port():
    """The smoke script stands on the port: nothing of the JAX package,
    not even its jax-free modules, is imported by the script itself."""
    mods = [m for m in _imports(REPO / "chip_smoke.py") if m]
    assert any(m.startswith("formula_vad_tpu_torch") for m in mods)
    for mod in mods:
        assert mod.split(".")[0] not in FORBIDDEN, mod


def test_imports_and_scores_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("modules ")


@pytest.mark.parametrize("module", ["formula_vad_tpu.ops.windows", "formula_vad_tpu.utils.logging"])
def test_reference_modules_the_port_copies_need_jax(module):
    """Why the port copies the windows and uses stdlib logging: importing these
    from the JAX package loads jax (through their packages' __init__)."""
    code = f"import sys; sys.modules['jax'] = None; import {module}"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "import of jax halted" in proc.stderr


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_their_originals(rel):
    got, want = (PACKAGE / rel).read_bytes(), (REFERENCE / rel).read_bytes()
    if rel != "config.py":
        assert got == want
        return
    # The module docstring's line naming where the upstream sources lay is
    # reworded in the copy; no other byte differs.
    got, want = got.splitlines(), want.splitlines()
    assert len(got) == len(want)
    assert [i for i, (a, b) in enumerate(zip(got, want)) if a != b] == [3]
