"""Every public name of shortseq_tpu has its counterpart in the same module
of shortseq_torch.  The JAX package is read by `ast` only, so nothing of
it is imported here: a module's public names are its top-level defs,
classes and module constants, its `__all__`, and, for a package's
`__init__.py`, the names it imports from its own package.  Two modules
live under new names in the port (MODULE_MAP); EXEMPT holds what the port
leaves out on purpose, each with its reason.  Each public function and
method of the JAX package also takes the same calls in the port
(test_signatures_take_jax_calls)."""

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
    ("ops/pallas_kernels.py", "hamming_pairwise_tiled.tile"):
        "the Pallas kernel's row tile; kernel B's tiles are fixed by its "
        "design for the card",
    ("ops/pallas_kernels.py", "hamming_pairwise_tiled.interpret"):
        "runs the Pallas kernel in interpret mode on the CPU; the port's "
        "CPU tensors take the plain version",
    ("ops/pallas_kernels.py", "calibrate_pairwise.platform"):
        "a jax platform name; the port calibrates on `device` (the "
        "parameter at its position)",
    ("dist/mesh.py", "initialize_distributed.**kwargs"):
        "forwarded to jax.distributed.initialize; the port names "
        "torch.distributed's (init_method, rank, world_size, device, "
        "timeout)",
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
            return set(_arg_names(node.args))
    raise AssertionError(f"{rel} defines no function {fn}")


def _arg_names(a):
    """A def's parameter names, `*args` and `**kwargs` with their stars."""
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append("*" + a.vararg.arg)
    if a.kwarg:
        names.append("**" + a.kwarg.arg)
    return names


def _port_params(fn):
    """The port callable's parameter names, starred as _arg_names."""
    stars = {inspect.Parameter.VAR_POSITIONAL: "*",
             inspect.Parameter.VAR_KEYWORD: "**"}
    return [stars.get(p.kind, "") + p.name
            for p in inspect.signature(fn).parameters.values()]


def _public_defs(rel):
    """(qualified name, ast def, drops its first parameter) of each
    public function of shortseq_tpu/<rel> and each public method (and
    __init__) of its public classes."""
    tree = ast.parse((JAX_PKG / rel).read_text())
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            yield node.name, node, False
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and (
                        item.name == "__init__"
                        or not item.name.startswith("_")):
                    decorators = {getattr(d, "id", None)
                                  for d in item.decorator_list}
                    if "property" in decorators:
                        continue
                    yield (f"{node.name}.{item.name}", item,
                           "classmethod" in decorators)


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


@pytest.mark.parametrize("rel", _module_files())
def test_signatures_take_jax_calls(rel):
    """Each public function and method of the JAX module takes the same
    calls in the port: JAX's positional parameters stand at the same
    positions, its keyword-only ones and its *args / **kwargs exist, and
    every parameter the port adds has a default (so a JAX-style call
    never fills one by position).  EXEMPT names the departures that the
    TPU forces, as "function.parameter"."""
    mod = _port_module(rel)
    exempt = {name for (r, name), _ in EXEMPT.items() if r == rel}
    bad = []
    for qual, node, bound in _public_defs(rel):
        if qual in exempt:
            continue
        target = mod
        for part in qual.split("."):
            target = getattr(target, part, None)
        if target is None or not callable(target):
            continue          # test_public_names_have_counterparts' case
        a = node.args
        positional = [x.arg for x in a.posonlyargs + a.args][bound:]
        port = inspect.signature(target).parameters
        port_positional = [
            p.name for p in port.values()
            if p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                          inspect.Parameter.POSITIONAL_OR_KEYWORD)]
        skip = {name.split(".")[-1] for name in exempt
                if name.rsplit(".", 1)[0] == qual}
        for i, name in enumerate(positional):
            if name in skip:
                continue
            if i >= len(port_positional) or port_positional[i] != name:
                bad.append(f"{qual}: {name} is not positional parameter {i}")
        names = set(_port_params(target))
        for name in [x.arg for x in a.kwonlyargs] \
                + [n for n in _arg_names(a) if n.startswith("*")]:
            if name not in skip and name not in names:
                bad.append(f"{qual}: no {name}")
        jax_names = {n.lstrip("*") for n in _arg_names(a)}
        for p in port.values():
            if p.name in jax_names or p.kind in (
                    inspect.Parameter.VAR_POSITIONAL,
                    inspect.Parameter.VAR_KEYWORD):
                continue
            if p.default is inspect.Parameter.empty:
                bad.append(f"{qual}: the port's {p.name} has no default")
    assert not bad, f"shortseq_torch {rel}: " + "; ".join(bad)


@pytest.mark.parametrize("key", sorted(EXEMPT), ids="/".join)
def test_exemptions_are_real(key):
    """Each exemption names something the JAX module has and the port
    does not, so the dict cannot go stale."""
    rel, name = key
    mod = _port_module(rel)
    if "." in name:
        fn, param = name.split(".")
        assert param in _jax_params(rel, fn)
        assert param not in _port_params(getattr(mod, fn))
        return
    src = (JAX_PKG / rel).read_text()
    assert f"def {name}(" in src
    assert not hasattr(mod, name)
