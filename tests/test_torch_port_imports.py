"""The port imports nothing of JAX and nothing of the JAX package: an ast
scan of every module under gstx_torch/ and of chip_smoke.py.  (A
sys.modules check would not do: a process may have JAX loaded for other
reasons.)"""

import ast
from pathlib import Path

import pytest

import torch_port_harness  # noqa: F401  (the CPU thread rule)

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "gstx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "gstx")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _forbidden(name):
    # exact top-level match: gstx_torch is not gstx
    return name.split(".")[0] in FORBIDDEN


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "gstx_torch/decode/dialog_engine.py" in names
    assert "gstx_torch/kernels/ffn.py" in names
    assert "gstx_torch/cli/generate.py" in names
    assert "gstx_torch/data/tokenizer.py" in names
    assert {"gstx_torch/eval/metrics.py", "gstx_torch/eval/rank_gen.py",
            "gstx_torch/eval/rank_disc.py", "gstx_torch/cli/evaluate_gen.py",
            "gstx_torch/cli/evaluate_disc.py",
            "gstx_torch/core/logging.py"} <= names
    assert {"gstx_torch/train/optim.py", "gstx_torch/train/train_gen.py",
            "gstx_torch/cli/train_gen.py", "gstx_torch/core/checkpoint.py",
            "gstx_torch/data/loader.py", "gstx_torch/data/cc12m.py",
            "gstx_torch/data/visdial.py", "gstx_torch/core/mesh.py"} <= names
    assert {"gstx_torch/train/train_disc.py", "gstx_torch/cli/train_disc.py",
            "gstx_torch/models/heads.py", "gstx_torch/models/mlm.py",
            "gstx_torch/eval/attacks.py", "gstx_torch/eval/attack_eval.py",
            "gstx_torch/cli/evaluate_gen_attack.py"} <= names
    assert {"gstx_torch/cli/selftrain.py", "gstx_torch/decode/beam.py",
            "gstx_torch/cli/inference.py",
            "gstx_torch/preprocessing/preprocess_visdial.py",
            "gstx_torch/preprocessing/convert_to_store.py",
            "gstx_torch/preprocessing/comp_cos_sim_mat.py",
            "gstx_torch/preprocessing/clip_filtering.py"} <= names
    assert "gstx_torch/models/tensor_parallel.py" in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(
    ROOT).as_posix())
def test_no_jax_or_reference_package_import(path):
    bad = [m for m in _imported_modules(path) if m and _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_matcher_is_exact_not_prefix():
    assert _forbidden("gstx") and _forbidden("gstx.models.layers")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("gstx_torch") and not _forbidden("gstx_torch.ops")
    assert not _forbidden("jaxlike")
