"""What the harness and the reference load: no JAX and no JAX package
anywhere, and nothing of the program in the reference."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

REF = os.path.join(REPO, "portbench", "reference")


def _modules_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint('\\n'.join("
         "sorted(sys.modules)))"], cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, check=True)
    return out.stdout.split()


def test_harness_and_reference_load_no_jax():
    mods = _modules_after(
        "import portbench.run, portbench.harness, portbench.generate, "
        "portbench.trace, portbench.calibrate, "
        "portbench.reference.analysis, portbench.reference.compare\n"
        "from portbench import harness\n"
        "import genrich_tpu_torch.pipeline, "
        "genrich_tpu_torch.engine.torch_bridge")
    tops = {m.split(".")[0] for m in mods}
    assert "genrich_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "genrich_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import portbench.reference.analysis, "
                          "portbench.reference.compare")
    assert not {m.split(".")[0] for m in mods} & {
        "genrich_tpu_torch", "genrich_tpu", "jax"}


def test_reference_sources_import_nothing_of_the_program():
    for f in os.listdir(REF):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, f)).read())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in (
                    "genrich_tpu_torch", "genrich_tpu", "jax"), (f, n)


def test_forbidden_modules_compare_whole_top_level_names():
    from portbench import run
    sys.modules.setdefault("genrich_tpu_torch_lookalike", sys)
    try:
        assert "genrich_tpu_torch_lookalike" not in run.forbidden_modules()
    finally:
        del sys.modules["genrich_tpu_torch_lookalike"]
