"""Nothing that the harness or the reference imports is JAX or the JAX
package (top-level names compared whole: ``fenapack_tpu_torch`` begins
with ``fenapack_tpu``), and the reference imports nothing of the
program."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

HERE = os.path.join(ROOT, "pcdbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "fenapack_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_in_any_source():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        tops = set(_imports(path))
        assert "fenapack_tpu_torch" not in tops, path
        assert not tops & FORBIDDEN, path


def test_loaded_modules_at_run_time():
    """What the harness and the program's entry points load, in a fresh
    process."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import pcdbench.run, pcdbench.steady, pcdbench.trace, "
        "pcdbench.control, pcdbench.reference.judge\n"
        "import fenapack_tpu_torch.bench, fenapack_tpu_torch.step3d, "
        "fenapack_tpu_torch.measure, fenapack_tpu_torch.models\n"
        "import glob, os\n"
        "for p in glob.glob(os.path.join(%r, 'configs', '*.py')) + "
        "glob.glob(os.path.join(%r, 'metrics', '*.py')):\n"
        "    pcdbench.run.load_module(p, 'm_' + os.path.basename(p)"
        ".replace('-', '_')[:-3])\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (ROOT, HERE, HERE))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert "fenapack_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
