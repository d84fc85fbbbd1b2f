"""The port's public surface against the JAX package's, read with ``ast``
(no module is imported).

Every public top-level name of every ``metadyn_tpu`` module (a function,
a class or an assigned name not starting with ``_``; in an ``__init__``
also the names it imports, its re-exports) has a counterpart of the same
name in the same module of ``metadyn_tpu_torch``.  The exceptions, each
with its reason, are in ``NO_COUNTERPART``.  No file of the port imports
``jax`` or ``metadyn_tpu``.
"""
import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = ROOT / "metadyn_tpu"
PORT = ROOT / "metadyn_tpu_torch"

# reference module -> why the port has no module of that name
NO_COUNTERPART = {
    "ops/packed_pallas.py": "Pallas kernel 5 (v1 pair force): ported as "
                            "csrc/packed_lj_force_v1.cu (ops/packed_v1_cuda.py)",
    "ops/packed_pallas2.py": "Pallas kernel 1 (pair force): ported as "
                             "csrc/packed_lj_force.cu (ops/packed_cuda.py)",
    "ops/packed_order_pallas.py": "Pallas kernels 2 and 3 (order-CV values "
                                  "and force): ported as csrc/packed_order.cu"
                                  " (ops/packed_order_cuda.py)",
    "ops/packed_fused_pallas.py": "Pallas kernel 4 (fused LJ + order CV) and "
                                  "its parts subsets: ported as csrc/"
                                  "packed_fused_lj_order.cu and csrc/"
                                  "packed_fused_parts.cu "
                                  "(ops/packed_fused_cuda.py)",
    "utils/cache.py": "JAX's persistent compile-cache policy: PyTorch runs "
                      "eagerly and the kernels build once per checkout "
                      "(ops/_build.py), so there is nothing to configure",
}


def public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
        elif path.name == "__init__.py" and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_reference_name_has_a_counterpart():
    missing = {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        if rel in NO_COUNTERPART:
            assert not (PORT / rel).exists(), rel
            continue
        port = PORT / rel
        if not port.exists():
            missing[rel] = "no module"
            continue
        lack = public_names(path) - public_names(port)
        if lack:
            missing[rel] = sorted(lack)
    assert not missing, missing
    for rel in NO_COUNTERPART:
        assert (REF / rel).exists(), f"stale exception: {rel}"


def test_port_imports_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {m}" for m in mods
                    if m.split(".")[0] in ("jax", "jaxlib", "metadyn_tpu")]
    assert not bad, bad
