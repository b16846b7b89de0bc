"""No module of crbench imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

CRBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "crnerf_tpu"}


def modules():
    for dirpath, _, files in os.walk(CRBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of every import in a file, nested ones too."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, CRBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = FORBIDDEN & set(imported(path))
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(CRBENCH, "reference")
    seen, todo = set(), [os.path.join(ref, f) for f in os.listdir(ref)
                         if f.endswith(".py")]
    while todo:    # the reference and every crbench module it reaches
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] != "crnerf_tpu_torch", \
                    f"{path} imports {name}"
                if name.split(".")[0] == "crbench":
                    mod = os.path.join(os.path.dirname(CRBENCH),
                                       *name.split("."))
                    todo += [p for p in (mod + ".py",
                                         os.path.join(mod, "__init__.py"))
                             if os.path.exists(p)]
    assert any(p.endswith("frame.py") for p in seen)


def test_running_modules_load_no_jax():
    code = ("import sys, crbench.run, crbench.control, crbench.reference."
            "train, crbench.reference.frame, crbench.traffic.trainer, "
            "crbench.traffic.serve_closed, crbench.traffic.serve_client, "
            "crnerf_tpu_torch.train.loop, crnerf_tpu_torch.apps.serve\n"
            "from crbench.harness import forbidden_loaded\n"
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(CRBENCH),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_client_process_imports_no_torch():
    code = ("import sys, crbench.traffic.serve_client\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == "
            "'torch'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(CRBENCH),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
