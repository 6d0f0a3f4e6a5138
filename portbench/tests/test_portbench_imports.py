"""Nothing the harness loads has the top-level name of JAX or of the JAX
package, and the reference loads nothing of the port: top-level module
names compared whole (the port's name begins with the JAX package's)."""
import ast
import glob
import os
import subprocess
import sys

import benchutil

JAX_NAMES = {"jax", "jaxlib", "flax", "patchaugnet_tpu"}


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=benchutil.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _loaded("from portbench import harness, program, faults, flops, readers, tracing\n"
                    "import glob\n"
                    "for p in glob.glob('portbench/traffic/*.py') + glob.glob('portbench/metrics/*.py'):\n"
                    "    harness.load_module(p, 'm')\n"
                    "import patchaugnet_tpu_torch.serving, patchaugnet_tpu_torch.train, patchaugnet_tpu_torch.models")
    assert "patchaugnet_tpu_torch" in names
    assert not names & JAX_NAMES


def test_reference_loads_nothing_of_the_port():
    names = _loaded("import portbench.reference.common, portbench.reference.patch_aug_net, "
                    "portbench.reference.pptnet, portbench.reference.tuple_step")
    assert not names & (JAX_NAMES | {"patchaugnet_tpu_torch"})


def test_reference_sources_import_no_program():
    for path in glob.glob(os.path.join(benchutil.BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (JAX_NAMES | {"patchaugnet_tpu_torch"}), (path, tops)


def test_name_comparison_is_whole():
    import patchaugnet_tpu_torch  # noqa: F401
    from portbench import harness

    assert harness.forbidden_modules() == []
