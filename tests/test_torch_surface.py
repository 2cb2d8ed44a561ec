"""Every public name of shortseq_tpu has its counterpart in the same module
of shortseq_torch.  The JAX package is read by `ast` only, so nothing of
it is imported here: a module's public names are its top-level defs,
classes and module constants, its `__all__`, and, for a package's
`__init__.py`, the names it imports from its own package.  Two modules
live under new names in the port (MODULE_MAP); EXEMPT holds what the port
leaves out on purpose, each with its reason."""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "shortseq_tpu"

MODULE_MAP = {"native_build.py": "_build.py",
              "ops/pallas_kernels.py": "ops/pairwise.py"}

# (JAX module, name) -> why the port has no counterpart.  A name
# "fn.param" is a parameter of a public function.
EXEMPT = {
    ("ops/bitpack.py", "_compact_mats"):
        "builds the TPU's bf16 dot operand of the lane combine; kernel A "
        "packs with integer ops",
    ("ops/bitpack.py", "_folded_mats"):
        "builds the TPU's block-diagonal dot operands of the folded pack; "
        "the port's folded layout is a view of [N, w4]",
    ("ops/bitpack.py", "_pack_folded_raw"):
        "the folded one-dot pack body; pack_folded runs kernel A on the "
        "unfolded view",
    ("dist/mesh.py", "data_mesh.devices"):
        "a list of jax devices; the port's mesh is a torch.distributed "
        "group (data_mesh(group=, device=))",
}


def _module_files():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _port_module(rel):
    rel = MODULE_MAP.get(rel, rel)
    name = "shortseq_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _targets(elt)


def public_names(rel):
    """The public names that shortseq_tpu/<rel> defines, read by ast."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                names.update(_targets(target))
            if any(isinstance(t, ast.Name) and t.id == "__all__"
                   for t in node.targets):
                names.update(e.value for e in node.value.elts)
        elif isinstance(node, ast.AnnAssign):
            names.update(_targets(node.target))
        elif (isinstance(node, ast.ImportFrom) and node.level
              and rel.endswith("__init__.py")):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def _jax_params(rel, fn):
    tree = ast.parse((JAX_PKG / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == fn:
            a = node.args
            return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    raise AssertionError(f"{rel} defines no function {fn}")


def test_module_list_is_complete():
    """The walk sees every module of the JAX package, each with a port."""
    files = _module_files()
    assert len(files) > 30 and "ops/bitpack.py" in files
    for rel in files:
        port = ROOT / "shortseq_torch" / MODULE_MAP.get(rel, rel)
        assert port.exists(), rel


@pytest.mark.parametrize("rel", _module_files())
def test_public_names_have_counterparts(rel):
    mod = _port_module(rel)
    exempt = {name for (r, name), _ in EXEMPT.items() if r == rel}
    missing = sorted(n for n in public_names(rel) - exempt
                     if not hasattr(mod, n))
    assert not missing, f"shortseq_torch lacks {rel}: {missing}"


@pytest.mark.parametrize("key", sorted(EXEMPT), ids="/".join)
def test_exemptions_are_real(key):
    """Each exemption names something the JAX module has and the port
    does not, so the dict cannot go stale."""
    rel, name = key
    mod = _port_module(rel)
    if "." in name:
        fn, param = name.split(".")
        assert param in _jax_params(rel, fn)
        assert param not in inspect.signature(getattr(mod, fn)).parameters
        return
    src = (JAX_PKG / rel).read_text()
    assert f"def {name}(" in src
    assert not hasattr(mod, name)
