"""The port stands alone: no module of src/repro_torch/ and not
chip_smoke.py imports jax or the reference package ``repro`` — checked on
the source (AST), so a lazy import inside a function counts too."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checker_sees_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from repro.core import gossip\n"
                     "    import jax.numpy as jnp\n")
    assert imported_roots(probe) >= {"repro", "jax"}


@pytest.mark.parametrize("module", [
    "core/kmeans.py", "core/baselines.py", "core/async_sim.py",
    "examples/quickstart.py", "examples/kmeans_scaling.py",
    "examples/cost_model.py", "kernels/kmeans_assign/kernel.py",
    "kernels/kmeans_assign/ref.py", "kernels/kmeans_assign/ops.py",
    "kernels/parzen_blend/kernel.py", "kernels/parzen_blend/ref.py",
    "kernels/parzen_blend/ops.py"])
def test_kmeans_slice_modules_are_checked(module):
    """The K-Means slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "kernels/ssd_scan/kernel.py", "kernels/ssd_scan/ref.py",
    "kernels/ssd_scan/ops.py", "models/ssm.py", "launch/serve.py",
    "examples/serve_decode.py"])
def test_serve_slice_modules_are_checked(module):
    """The serving slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "checkpoint/__init__.py", "checkpoint/checkpoint.py",
    "checkpoint/codec.py"])
def test_checkpoint_slice_modules_are_checked(module):
    """The checkpoint slice's modules are among the files checked above,
    and none of them, nor any other file of the port, imports msgpack:
    the GPU machine has none (checkpoint/codec.py writes the format)."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES
    assert not any("msgpack" in imported_roots(p) for p in PORT_FILES)


@pytest.mark.parametrize("module", ["models/moe.py", "models/blocks.py",
                                    "models/model.py"])
def test_moe_slice_modules_are_checked(module):
    """The MoE slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", ["launch/mesh.py", "examples/train_lm.py",
                                    "launch/steps.py", "core/tree.py"])
def test_mesh_slice_modules_are_checked(module):
    """The mesh slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "launch/sharding.py", "models/hints.py", "launch/hlo_analysis.py",
    "launch/dryrun.py", "launch/steps.py"])
def test_dryrun_slice_modules_are_checked(module):
    """The dry-run slice's modules are among the files checked above."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


@pytest.mark.parametrize("name", ["_torch_tp_ranks.py",
                                  "_torch_tp_serve_ranks.py",
                                  "_torch_tp_ssm_ranks.py",
                                  "_torch_tp_card_check.py"])
def test_rank_programs_import_neither_jax_nor_reference(name):
    """The tensor-parallel rank programs and their card check run on a
    machine without jax (the card's), so they import the port only."""
    path = ROOT / "tests" / name
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"tests/{name} imports {sorted(bad)}"
