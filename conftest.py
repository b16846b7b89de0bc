"""Collection hook for the whole test tree.

``tests/test_parity.py`` and ``tests/test_import_ckpt.py`` hold the JAX
package to the original PyTorch implementation, which they import from the
directory named by ``test_parity.REF``. Where that directory is absent their
items are skipped with a reason, so the rest of the suite can report a
clean exit; where it exists they run as before. ``REF`` is read from
``test_parity.py``'s source, so the skip holds whichever of the two files
is collected, and alone. Imports neither jax nor torch.
"""

import ast
import os

import pytest

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
_NEEDS_REFERENCE = ("test_parity.py", "test_import_ckpt.py")
# items of those files that touch only the checkpoint converter, and run
# without the reference; each must still be defined in its file
_RUNS_WITHOUT_REFERENCE = {"test_import_ckpt.py":
                           ("test_unknown_prefix_fails_loud",)}


def _source(name: str) -> str:
    with open(os.path.join(_TESTS, name)) as f:
        return f.read()


def _reference_dir() -> str:
    """``REF`` as ``tests/test_parity.py`` assigns it."""
    for node in ast.parse(_source("test_parity.py")).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "REF"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise pytest.UsageError("tests/test_parity.py assigns no REF")


def _exempt(name: str) -> tuple:
    """The exempt test functions of file ``name``; a name that its file no
    longer defines is an error, not a silent skip."""
    names = _RUNS_WITHOUT_REFERENCE.get(name, ())
    defined = {node.name for node in ast.walk(ast.parse(_source(name)))
               if isinstance(node, ast.FunctionDef)}
    missing = [n for n in names if n not in defined]
    if missing:
        raise pytest.UsageError(f"conftest.py exempts {missing} from the "
                                f"reference skip, but tests/{name} defines "
                                "no such test")
    return names


def _guarded(item):
    """The name of the guarded file ``item`` belongs to, else None."""
    name = item.path.name
    if name in _NEEDS_REFERENCE and str(item.path.parent) == _TESTS:
        return name
    return None


def pytest_collection_modifyitems(config, items):
    files = {_guarded(item) for item in items} - {None}
    if not files:
        return
    ref = _reference_dir()
    if os.path.isdir(ref):
        return
    exempt = {name: _exempt(name) for name in files}
    skip = pytest.mark.skip(reason=f"needs {ref}")
    for item in items:
        name = _guarded(item)
        if name and getattr(item, "originalname", item.name) \
                not in exempt[name]:
            item.add_marker(skip)
