"""The port's import boundary: no module of ``improved_body_parts_torch``
and not ``chip_smoke.py`` imports JAX, jaxlib, Flax or the JAX package,
not even a module there that needs no JAX.  Each file is parsed with
``ast``, so an import inside a function counts as much as one at the
top; one case a subpackage (and the package's own ``__init__``, and the
chip script)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "improved_body_parts_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "improved_body_parts_tpu")
UNITS = sorted(d.name for d in PORT.iterdir()
               if (d / "__init__.py").is_file()) + ["__init__.py",
                                                    "chip_smoke.py"]


def _files(unit):
    if unit == "chip_smoke.py":
        return [ROOT / unit]
    if unit == "__init__.py":
        return [PORT / unit]
    return sorted((PORT / unit).rglob("*.py"))


def _imports(path):
    """(line, top-level module) of every absolute import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


@pytest.mark.parametrize("unit", UNITS)
def test_port_imports_no_jax(unit):
    files = _files(unit)
    assert files, unit
    offenders = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
                 for p in files for line, mod in _imports(p)
                 if mod in FORBIDDEN]
    assert not offenders, "\n".join(offenders)


def test_the_boundary_check_sees_nested_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from jax import numpy\n"
                     "    import improved_body_parts_tpu.ops\n")
    assert [m for _, m in _imports(probe)] == ["jax",
                                               "improved_body_parts_tpu"]
