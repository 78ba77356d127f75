"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
it imports where JAX is absent, its entry points refuse to fall back to the
CPU without being asked, and kernel dispatch follows the tensor's device.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.configs.rwkv6_1_6b import reduced_delta_recipe
from repro_torch.core.delta_dense import init_delta_linear_state
from repro_torch.core.deltarglru import init_deltarglru_model
from repro_torch.core.deltarwkv import init_deltarwkv_model
from repro_torch.core.program import compile_delta_program
from repro_torch.data.lm_data import lm_batch
from repro_torch.data.synthetic import digit_batch, gas_batch
from repro_torch.dist.elastic import best_mesh
from repro_torch.dist.serving import ShardedStreamFleet
from repro_torch.kernels import _build, ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.kernels.delta_q8 import deltagru_q8_step, pack_delta_weights_q8
from repro_torch.kernels.deltagru_seq import deltagru_seq_step, pack_gru_layer
from repro_torch.models.gru_rnn import (GruTaskConfig, init_gru_model,
                                        init_lstm_model, model_from_numpy)
from repro_torch.models.lm import (init_lm, init_lm_caches,
                                   lm_params_from_numpy)
from repro_torch.quant.export import quantize_delta_model
from repro_torch.ft import checkpoint as ft_checkpoint
from repro_torch.serve.engine import DeltaStreamEngine, LmEngine
from repro_torch.serve.resilience import ResiliencePolicy, serve_resumable

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_the_scan_covers_every_port_module_and_kernel_source():
    names = {str(p.relative_to(PORT)) for p in PORT_FILES if PORT in p.parents}
    for mod in ("core/deltarwkv.py", "core/deltarglru.py",
                "models/rwkv.py", "models/rglru.py", "configs/base.py",
                "configs/rwkv6_1_6b.py", "configs/recurrentgemma_9b.py",
                "kernels/delta_spmv.py", "kernels/rwkv6_scan.py",
                "kernels/rglru_scan.py", "kernels/deltagru_cell.py",
                "kernels/ref.py", "core/delta_dense.py", "core/sparsity.py",
                "ft/checkpoint.py", "ft/heartbeat.py", "ft/straggler.py",
                "ft/restart.py", "serve/faults.py", "serve/resilience.py",
                "quant/qat.py", "train/ctc.py", "train/losses.py",
                "train/optim.py", "train/trainer.py", "data/synthetic.py",
                "dist/grad_compress.py", "dist/elastic.py",
                "dist/serving.py", "serve/router.py", "serve/loadgen.py",
                "models/common.py", "models/attention.py", "models/ffn.py",
                "models/blocks.py", "models/lm.py", "configs/registry.py",
                "configs/llama3_2_1b.py", "configs/smollm_360m.py",
                "configs/olmo_1b.py", "configs/qwen2_5_32b.py",
                "configs/deepseek_v2_lite_16b.py",
                "configs/granite_moe_3b_a800m.py",
                "configs/llama3_2_vision_11b.py",
                "configs/seamless_m4t_large_v2.py", "launch/__init__.py",
                "launch/serve.py", "core/__init__.py", "quant/__init__.py",
                "models/__init__.py", "models/mla.py", "models/moe.py",
                "launch/train.py", "data/lm_data.py", "data/pipeline.py",
                "data/__init__.py", "train/__init__.py",
                "dist/sharding.py", "dist/pipeline.py", "models/moe_ep.py",
                "launch/specs.py", "dist/__init__.py"):
        assert mod in names, mod
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in (PORT / "csrc").glob("*.cu"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    # "repro_torch" is the port itself; only the exact top-level names
    # "jax", "jaxlib" and "repro" are forbidden
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"
    text = path.read_text()
    assert "__import__(\"jax" not in text and "import_module(\"jax" not in text


def test_port_imports_with_jax_and_repro_blocked():
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_package_reexports_import_with_jax_and_repro_blocked():
    """``repro_torch.core``, ``.quant``, ``.models``, ``.data``, ``.train``
    and ``.dist`` re-export the public names of the JAX package's
    ``__init__`` files (the core's TPU perf-model section aside), importing
    neither JAX nor a card."""
    tpu_only = {"TpuChipSpec", "V5E", "tpu_batch1_gru_roofline",
                "batch_sweep"}
    want = {}
    for pkg in ("core", "quant"):
        tree = ast.parse((ROOT / "src" / "repro" / pkg / "__init__.py")
                         .read_text())
        want[pkg] = sorted({a.asname or a.name for node in tree.body
                            if isinstance(node, ast.ImportFrom)
                            for a in node.names} - tpu_only)
    want["models"] = ["init_lm", "init_lm_caches", "lm_forward",
                      "lm_prefill", "lm_decode", "lm_params_from_numpy",
                      "KVCache", "MlaCache", "make_schedule"]
    want["data"] = ["lm_batch", "lm_batch_stream", "token_batch",
                    "Prefetcher", "shard_batch", "prefetch_to_mesh"]
    want["train"] = ["make_lm_train_step", "make_lm_train_step_fn",
                     "make_gru_train_step", "init_train_state", "TrainState",
                     "train_loop", "LoopHooks"]
    tree = ast.parse((ROOT / "src" / "repro" / "dist" / "__init__.py")
                     .read_text())
    want["dist"] = sorted(ast.literal_eval(node.value) for node in tree.body
                          if isinstance(node, ast.Assign)
                          and node.targets[0].id == "__all__")[0]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for pkg, names in {want!r}.items():\n"
            "    m = importlib.import_module('repro_torch.' + pkg)\n"
            "    missing = [n for n in names if not hasattr(m, n)]\n"
            "    assert not missing, (pkg, missing)\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _small_model():
    return init_gru_model(0, GruTaskConfig(40, 48, 2, 12), device="cpu")


def _np_tree(model):
    return {"gru": [tuple(t.numpy() for t in p) for p in model["gru"]],
            "head": model["head"].numpy(), "head_b": model["head_b"].numpy()}


@pytest.mark.parametrize("entry", [
    "compile_delta_program", "quantize_delta_model", "init_gru_model",
    "model_from_numpy", "DeltaStreamEngine", "init_lstm_model",
    "compile_delta_program_lstm", "DeltaStreamEngine_lstm",
    "init_deltarwkv_model", "init_deltarglru_model",
    "compile_delta_program_rwkv6", "DeltaStreamEngine_rglru",
    "reduced_delta_recipe", "init_delta_linear_state", "checkpoint_restore",
    "serve_resumable", "digit_batch", "gas_batch", "best_mesh",
    "ShardedStreamFleet", "init_lm", "init_lm_caches", "LmEngine",
    "launch_serve", "lm_params_from_numpy", "lm_batch", "launch_train",
    "launch_train_model_parallel"])
def test_default_device_without_cuda_raises(entry, monkeypatch, tmp_path):
    model = _small_model()
    cfg = GruTaskConfig(40, 48, 2, 12)
    lstm = init_lstm_model(0, cfg, device="cpu")
    rwkv = init_deltarwkv_model(0, 64, 1, 12, device="cpu")
    rglru = init_deltarglru_model(0, 64, 1, 12, device="cpu")
    lm_cfg = GruTaskConfig(64, 64, 1, 12)
    zoo_cfg = get_config("llama3.2-1b").reduced()
    zoo = init_lm(0, zoo_cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "compile_delta_program": lambda: compile_delta_program(model),
        "quantize_delta_model": lambda: quantize_delta_model(model),
        "init_gru_model": lambda: init_gru_model(0, cfg),
        "model_from_numpy": lambda: model_from_numpy(_np_tree(model)),
        "DeltaStreamEngine": lambda: DeltaStreamEngine(
            compile_delta_program(model, device="cpu"), cfg),
        "init_lstm_model": lambda: init_lstm_model(0, cfg),
        "compile_delta_program_lstm": lambda: compile_delta_program(
            lstm, cell="lstm"),
        "DeltaStreamEngine_lstm": lambda: DeltaStreamEngine(
            compile_delta_program(lstm, cell="lstm", device="cpu"), cfg),
        "init_deltarwkv_model": lambda: init_deltarwkv_model(0, 64, 1, 12),
        "init_deltarglru_model": lambda: init_deltarglru_model(0, 64, 1, 12),
        "compile_delta_program_rwkv6": lambda: compile_delta_program(
            rwkv, cell="rwkv6"),
        "DeltaStreamEngine_rglru": lambda: DeltaStreamEngine(
            compile_delta_program(rglru, cell="rglru", device="cpu"),
            lm_cfg),
        "reduced_delta_recipe": lambda: reduced_delta_recipe(0),
        "init_delta_linear_state": lambda: init_delta_linear_state(4, 3),
        "checkpoint_restore": lambda: ft_checkpoint.restore(
            str(tmp_path), {"w": torch.zeros(2)}),
        "serve_resumable": lambda: serve_resumable(
            compile_delta_program(model, device="cpu"), cfg, [],
            ResiliencePolicy()),
        "digit_batch": lambda: digit_batch(0, batch=2, max_t=16),
        "gas_batch": lambda: gas_batch(0, batch=2, t_len=8),
        "best_mesh": lambda: best_mesh(),
        "ShardedStreamFleet": lambda: ShardedStreamFleet(
            compile_delta_program(model, device="cpu"), cfg, n_streams=8),
        "init_lm": lambda: init_lm(0, zoo_cfg),
        "init_lm_caches": lambda: init_lm_caches(zoo_cfg, 2, 8),
        "LmEngine": lambda: LmEngine(zoo, zoo_cfg, 2, 8),
        "launch_serve": lambda: launch_serve.main(
            ["--arch", "llama3.2-1b", "--reduced"]),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(
            {"w": np.zeros(2, np.float32)}),
        "lm_batch": lambda: lm_batch(0, zoo_cfg, 2, 8),
        "launch_train": lambda: launch_train.main(
            ["--arch", "llama3.2-1b", "--reduced", "--steps", "1"]),
        "launch_train_model_parallel": lambda: launch_train.main(
            ["--arch", "llama3.2-1b", "--reduced", "--steps", "1",
             "--model-parallel", "2"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_explicit_cpu_device_runs_plain_versions():
    model = _small_model()
    prog = compile_delta_program(model, "fused_q8", device="cpu")
    assert prog.device.type == "cpu"
    eng = DeltaStreamEngine(prog, GruTaskConfig(40, 48, 2, 12), device="cpu")
    ops.reset_launch_counts()
    out = eng.step_many(np.ones((3, 40), np.float32))
    assert out.shape == (3, 12) and torch.isfinite(out).all()
    assert ops.launch_counts() == {k.name: 0 for k in ops.KERNELS}


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    g = torch.Generator().manual_seed(0)
    w_x, w_h = torch.randn(144, 40, generator=g), torch.randn(144, 48,
                                                              generator=g)
    m, h = torch.zeros(2, 192), torch.zeros(2, 48)
    dx, dh = torch.ones(2, 40), torch.zeros(2, 48)
    ops.reset_launch_counts()
    deltagru_seq_step(pack_gru_layer(w_x, w_h), m, h, dx, dh)
    deltagru_q8_step(pack_delta_weights_q8(w_x, w_h), m, h, dx, dh)
    ops.deltagru_cell_fused(w_x, w_h, m, h, dx, dh)
    r = torch.ones(1, 2, 3, 64)
    ops.rwkv6_scan(r, r, r, r * 0.5, torch.zeros(2, 64))
    ops.rwkv6_scan(r.bfloat16(), r.bfloat16(), r.bfloat16(), r * 0.5,
                   torch.zeros(2, 64))
    ops.rglru_scan(torch.ones(1, 3, 8), torch.full((1, 3, 8), 0.5))
    assert sum(ops.launch_counts().values()) == 0


def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert ops.launches_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="no kernel"):
        ops.launches_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        ops.launches_kernel(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.require(cpu, "x", torch.float32, (2,))


def test_build_is_keyed_by_source_hash_and_lazy():
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
        path = _build.library_path(src)
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(src)        # deterministic
        assert path.name.startswith(Path(src).stem + "-")
    assert not _build._LIBS                            # nothing loaded here


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300, cwd=script.parent)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
