"""The port stands alone: no file of `cake_tpu_torch/`, nor
`chip_smoke.py` or `kernel_ablation.py`, imports jax or the JAX package, and the package
imports with jax made unimportable."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "cake_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "kernel_ablation.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "cake_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("cake_tpu_torch", "serve", "engine.py") in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_cake_tpu_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_package_imports_with_jax_unavailable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cake_tpu'] = None\n"
        "import cake_tpu_torch.api.server, cake_tpu_torch.master\n"
        "import cake_tpu_torch.models.llama.paged\n"
        "import cake_tpu_torch.ops.ragged_paged_attention\n"
        "import cake_tpu_torch.models.llama.params\n"
        "import cake_tpu_torch.ops.int4_matmul, cake_tpu_torch.ops.quant\n"
        "import cake_tpu_torch.context, cake_tpu_torch.cli\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'cake_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
