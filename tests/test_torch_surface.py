"""The port's public surface holds the JAX package's.

Both source trees are read with ``ast``; nothing of JAX is imported, and
the port is imported to read its signatures.  Every public top-level
function or class of each ``nerfacc_tpu`` module, and every name such a
module imports from the package, must exist in the same module of
``nerfacc_tpu_torch``; every argument of a public function, every field of
a flax module or NamedTuple (its annotated class attributes, inherited ones
included) and every argument of a class's ``__init__`` must be taken by the
port's counterpart.  What differs stands in ``NO_PORT``, with the port's
counterpart (or None) and the reason; anything neither ported nor mapped
fails.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "nerfacc_tpu"

_INTERPRET = "Pallas interpret mode off the TPU; in the port a CPU tensor takes the kernel's plain version"
_KEY = "a torch.Generator (or the draws themselves) takes the place of a JAX PRNG key"

# "module.name" for a name, "module.name(arg)" for an argument or field:
# (the port's counterpart in the same module or signature, or None; why).
NO_PORT = {
    # Kernel entries, renamed: the port's wrappers are named for what they
    # compute, and each plain version is `<wrapper>_plain`.
    "nerfacc_tpu.ops.occupancy_query_pallas": ("occupancy_query", "K1's wrapper"),
    "nerfacc_tpu.ops.occupancy_query_ref": ("occupancy_query_plain", "K1's plain version"),
    "nerfacc_tpu.ops.table_grad_ref": ("table_grad_sorted_plain", "K5's plain version"),
    "nerfacc_tpu.ops.occ_query.occupancy_query_pallas": ("occupancy_query", "K1's wrapper"),
    "nerfacc_tpu.ops.occ_query.occupancy_query_ref": ("occupancy_query_plain", "K1's plain version"),
    "nerfacc_tpu.ops.table_grad.table_grad_ref": ("table_grad_sorted_plain", "K5's plain version"),
    "nerfacc_tpu.ops.table_grad.table_grad_factors_sorted_u10": ("table_grad_u10", "K2's wrapper"),
    "nerfacc_tpu.ops.table_grad.table_grad_factors_sorted": (
        ("table_grad_w3", "table_grad_w8"), "K4, one wrapper for each `wpack`"),
    "nerfacc_tpu.ops.table_grad.table_grad_factors_sorted_pos": ("table_grad_pos", "K6's wrapper"),
    "nerfacc_tpu.ops.table_grad.cell_max_sorted": ("cell_max", "K3's wrapper, which takes the draws unsorted"),
    # Names that take no port.
    "nerfacc_tpu.ops.table_grad.on_tpu": (
        None, "picks Pallas or interpret mode; in the port a tensor's device picks kernel or plain version"),
    "nerfacc_tpu.parallel.multihost.data_spec": (
        None, "builds a JAX PartitionSpec; the port shards with shard_rays(..., axis=) and has no such object"),
    "nerfacc_tpu.datasets._native.available": (
        None, "the JAX loader falls back to numpy when its library fails to load; the port's get_lib builds "
              "the library or raises, so there is nothing to ask"),
    # Arguments, renamed or taking no port.
    "nerfacc_tpu.grid.traverse_grids(pallas_interpret)": (None, _INTERPRET),
    "nerfacc_tpu.grid.traverse_and_compact(pallas_interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.table_grad_sorted(dg_sorted)": (
        "dg", "K5 reads the cotangent in sample order, through the permutation `perm`"),
    "nerfacc_tpu.ops.table_grad.table_grad_sorted(W)": (
        None, "the Pallas kernel's window of rows; K5 walks warp spans of sorted samples"),
    "nerfacc_tpu.ops.table_grad.table_grad_sorted(CH)": (None, "the Pallas kernel's chunk of samples a step"),
    "nerfacc_tpu.ops.table_grad.table_grad_sorted(interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.hash_table_lookup_sized(interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.hash_lookup_combine(interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.hash_lookup_combine3(interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.hash_lookup_combine_pos(interpret)": (None, _INTERPRET),
    "nerfacc_tpu.ops.table_grad.hash_lookup_combine_pos(fetch_spec)": (
        "fetches", "a tuple of Fetch records takes the place of the spec's tuples"),
    "nerfacc_tpu.ops.table_grad.hash_lookup_combine_pos(level_span)": (
        None, "the rows of a span, for the Pallas kernel's span-local rows; K6 sums over the absolute rows "
              "of the whole table"),
    "nerfacc_tpu.models.ngp.NGPRadianceField(num_dim)": (None, "declared by the flax field and read nowhere"),
    "nerfacc_tpu.models.ngp.NGPRadianceField(param_dtype)": (
        None, "declared by the flax field and read nowhere; parameters are float32, compute_dtype casts at use"),
    "nerfacc_tpu.models.ngp.NGPDensityField(num_dim)": (None, "declared by the flax field and read nowhere"),
    "nerfacc_tpu.parallel.mesh.make_mesh(devices)": (
        "group", "a torch.distributed group of ranks takes the place of a list of devices"),
    "nerfacc_tpu.parallel.multihost.make_hybrid_mesh(devices)": (
        "group", "a torch.distributed group of ranks takes the place of a list of devices"),
    "nerfacc_tpu.parallel.train.make_parallel_train_step(tx)": (
        "optimizer", "a torch.optim optimizer takes the place of an optax transformation"),
    "nerfacc_tpu.parallel.train.make_parallel_propnet_train_step(tx_field)": (
        "optimizer_field", "a torch.optim optimizer takes the place of an optax transformation"),
    "nerfacc_tpu.parallel.train.make_parallel_propnet_train_step(tx_prop)": (
        "optimizer_prop", "a torch.optim optimizer takes the place of an optax transformation"),
    "nerfacc_tpu.pdf.importance_sampling(key)": ("generator", _KEY),
    "nerfacc_tpu.rendering.occgrid_render_rays(key)": ("generator", _KEY),
    "nerfacc_tpu.rendering.propnet_render_rays(key)": ("generator", _KEY),
    "nerfacc_tpu.rendering.occgrid_render_rays_test(capacity_buckets)": (
        None, "bounds how many jit variants of a round compile; the port runs each round at its alive count"),
}


def _module_name(path: Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__version__"


def _args(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


JAX_MODULES = sorted(JAX_PKG.rglob("*.py"))
_CLASSES = {}  # every class of the JAX package by name, for inherited fields
for _path in JAX_MODULES:
    for _node in _parse(_path).body:
        if isinstance(_node, ast.ClassDef):
            _CLASSES.setdefault(_node.name, _node)


def _fields(cls: ast.ClassDef, seen=()) -> list:
    """A class's annotated attributes and ``__init__`` arguments, its JAX
    package bases' first."""
    out = []
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else getattr(base, "attr", None)
        if name in _CLASSES and name not in seen:
            out += _fields(_CLASSES[name], seen + (name,))
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            out.append(stmt.target.id)
        elif isinstance(stmt, ast.FunctionDef) and stmt.name == "__init__":
            out += _args(stmt)
    return out


def jax_surface(path: Path) -> dict:
    """``{name: arguments or fields, or None for an imported name}`` of the
    module's public top-level functions and classes and of the names it
    imports from the package."""
    out = {}
    for node in _parse(path).body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = _fields(node)
        elif isinstance(node, ast.ImportFrom) and (node.level > 0 or (node.module or "").startswith("nerfacc_tpu")):
            for alias in node.names:
                out.setdefault(alias.asname or alias.name, None)
    return {k: v for k, v in out.items() if _public(k)}


def _port_module(jax_module: str):
    return importlib.import_module(jax_module.replace("nerfacc_tpu", "nerfacc_tpu_torch", 1))


def _takes(obj, arg: str) -> bool:
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):
        params = {}
    return arg in params or (inspect.isclass(obj) and hasattr(obj, arg))


def _gaps(path: Path):
    """The JAX module's names and arguments that the port's module lacks,
    as ``NO_PORT`` keys."""
    mod = _module_name(path)
    port = _port_module(mod)
    for name, args in jax_surface(path).items():
        if not hasattr(port, name):
            yield f"{mod}.{name}"
            continue
        for arg in args or ():
            if not _takes(getattr(port, name), arg):
                yield f"{mod}.{name}({arg})"


@pytest.mark.parametrize("path", JAX_MODULES, ids=lambda p: _module_name(p))
def test_every_public_name_and_argument_is_ported_or_mapped(path):
    unmapped = [gap for gap in _gaps(path) if gap not in NO_PORT]
    assert unmapped == [], f"neither ported nor in NO_PORT: {unmapped}"


def test_every_mapped_entry_is_a_real_gap_with_its_counterpart():
    gaps = {gap for path in JAX_MODULES for gap in _gaps(path)}
    stale = sorted(set(NO_PORT) - gaps)
    assert stale == [], f"NO_PORT entries that the port has, or the JAX package lacks: {stale}"
    for key, (counterpart, reason) in NO_PORT.items():
        assert reason, key
        if counterpart is None:
            continue
        mod, _, rest = key.partition("(")
        if rest:  # an argument renamed: the port's function takes the new name
            owner, name = mod.rsplit(".", 1)
            assert _takes(getattr(_port_module(owner), name), counterpart), key
        else:
            owner = mod.rsplit(".", 1)[0]
            for c in (counterpart,) if isinstance(counterpart, str) else counterpart:
                assert hasattr(_port_module(owner), c), key


def test_the_surface_reader_sees_what_it_should():
    # The reader finds imported names, inherited flax fields and arguments.
    rendering = jax_surface(JAX_PKG / "rendering.py")
    assert rendering["traverse_and_compact"] is None  # from .grid
    assert rendering["chunked_ray_components"] == ["rays_o", "rays_d", "ray_indices", "chunk"]
    assert "lattice_per_round" in rendering["occgrid_render_rays_test"]
    mlp = jax_surface(JAX_PKG / "models" / "barf.py")
    assert {"x_dim", "min_deg", "max_deg", "use_identity"} <= set(mlp["AnnealedSinusoidalEncoder"])
    assert "table_grad" in jax_surface(JAX_PKG / "models" / "hash_soa.py")["HashGridEncoderGrouped"]
    assert jax_surface(JAX_PKG / "__init__.py")["__version__"] is None  # from .version


def test_version_module_matches_the_jax_package():
    (assign,) = _parse(JAX_PKG / "version.py").body
    import nerfacc_tpu_torch
    from nerfacc_tpu_torch import version

    assert version.__version__ == nerfacc_tpu_torch.__version__ == ast.literal_eval(assign.value)
