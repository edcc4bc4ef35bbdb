"""Problem/cache/state serialization: the runtime analogue of the reference
freezing its whole solver into generated source files (reference:
src/tinympc/codegen.cpp:322-479 emits every struct as literals).
Counterpart of the JAX package's ``utils/serialization.py``, file for file:
either package reads what the other writes.

Format: each ``.npz`` carries a typed JSON manifest (``__manifest__``)
recording a format version, the tree's type name, and per-leaf field
paths/shapes/dtypes; leaves are ``leaf_0, leaf_1, ...``. Leaf names are the
JAX package's ``jax.tree_util.keystr`` paths (``.A`` for a field, ``[0].x``
inside a tuple, ``['k']`` in a dict), in its order (fields in declaration
order, dict keys sorted); the settings' static fields (``max_iter``,
``check_termination``, the bound flags, ``alpha``) are not leaves, as in
the JAX package. Loads validate the file against the manifest and the
manifest against the expected structure, so a corrupt, truncated, or
mismatched checkpoint fails loudly with the offending field named -- the
counterpart of the reference's compile-time guarantee that a frozen
workspace matches ``glob_opts.hpp`` dims (codegen.cpp:131-160).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any

import numpy as np
import torch

from ..types import DEFAULT_DEVICE, Cache, Problem, Settings

FORMAT_VERSION = 2

# Fields that are static metadata in the JAX package (``pytree_node=False``)
# and so are not leaves of a checkpoint.
_STATIC_FIELDS = {
    "Settings": ("max_iter", "check_termination", "en_state_bound",
                 "en_input_bound", "alpha"),
}


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """``(key suffix, child)`` pairs of a container, or None for a leaf."""
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float,
                         bool, complex)):
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{k}", getattr(tree, k)) for k in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        static = _STATIC_FIELDS.get(type(tree).__name__, ())
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree) if f.name not in static]
    raise TypeError(f"cannot serialize a {type(tree).__name__}")


def _flatten_with_names(tree: Any, prefix: str = "") -> tuple[list[str], list[Any]]:
    if tree is None:
        return [], []
    kids = _children(tree)
    if kids is None:
        return [prefix], [tree]
    names, leaves = [], []
    for key, child in kids:
        n, v = _flatten_with_names(child, prefix + key)
        names += n
        leaves += v
    return names, leaves


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``: tensors on the template leaf's device, Python
    scalars as Python scalars, arrays as arrays."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        arr = next(leaves)
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(arr).to(template.device)
        if isinstance(template, (int, float, bool, complex)):
            return type(template)(arr.item())
        return arr
    values = [_unflatten(child, leaves) for _, child in kids]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*values)
    if isinstance(template, (tuple, list)):
        return type(template)(values)
    if isinstance(template, dict):
        return dict(zip(sorted(template), values))
    return dataclasses.replace(
        template, **{k[1:]: v for (k, _), v in zip(kids, values)})


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype_name(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def save_pytree(path: str | pathlib.Path, tree: Any) -> None:
    """Save a dataclass/NamedTuple tree of tensors as npz + typed manifest."""
    names, leaves = _flatten_with_names(tree)
    arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(leaves)}
    manifest = {
        "format_version": FORMAT_VERSION,
        "type": type(tree).__name__,
        "leaves": [
            {"name": n, "shape": list(a.shape), "dtype": str(a.dtype)}
            for n, a in zip(names, arrays.values())
        ],
    }
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def read_manifest(path: str | pathlib.Path) -> dict:
    """Return the typed manifest of a checkpoint, or raise ValueError."""
    with np.load(path) as d:
        if "__manifest__" not in d.files:
            raise ValueError(
                f"{path}: no __manifest__ — not a v{FORMAT_VERSION} checkpoint"
            )
        try:
            manifest = json.loads(bytes(d["__manifest__"].tobytes()).decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt manifest: {e}") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ValueError(f"{path}: malformed manifest (no 'leaves')")
    if manifest.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"{path}: format version {manifest['format_version']} is newer "
            f"than supported ({FORMAT_VERSION})"
        )
    return manifest


def load_leaves(path: str | pathlib.Path) -> list[np.ndarray]:
    """Load raw leaves, validating each against the manifest entry."""
    manifest = read_manifest(path)
    entries = manifest["leaves"]
    with np.load(path) as d:
        leaves = []
        for i, ent in enumerate(entries):
            key = f"leaf_{i}"
            if key not in d.files:
                raise ValueError(
                    f"{path}: truncated — leaf {i} ({ent['name']}) missing"
                )
            arr = d[key]
            if list(arr.shape) != list(ent["shape"]):
                raise ValueError(
                    f"{path}: leaf {ent['name']} shape {arr.shape} != "
                    f"manifest {tuple(ent['shape'])}"
                )
            if str(arr.dtype) != ent["dtype"]:
                raise ValueError(
                    f"{path}: leaf {ent['name']} dtype {arr.dtype} != "
                    f"manifest {ent['dtype']}"
                )
            leaves.append(arr)
    return leaves


def save_like(path: str | pathlib.Path, tree: Any) -> None:
    save_pytree(path, tree)


def load_like(path: str | pathlib.Path, template: Any) -> Any:
    """Load into the same tree structure as ``template``, validating every
    field path, shape, and dtype against the template -- a resume with the
    wrong problem dims, dtype, or field layout fails loudly by field name.
    Tensor leaves land on the device of the template's leaf."""
    manifest = read_manifest(path)
    leaves = load_leaves(path)
    names, tleaves = _flatten_with_names(template)
    if len(names) != len(leaves):
        raise ValueError(
            f"{path}: expected {len(names)} leaves "
            f"({type(template).__name__}), found {len(leaves)} "
            f"(saved type {manifest.get('type', '?')})"
        )
    for ent, name, tl in zip(manifest["leaves"], names, tleaves):
        if ent["name"] != name:
            raise ValueError(
                f"{path}: field order mismatch — saved {ent['name']!r}, "
                f"template expects {name!r} (saved type "
                f"{manifest.get('type', '?')}, template "
                f"{type(template).__name__})"
            )
        shape = tuple(tl.shape) if isinstance(tl, torch.Tensor) else \
            np.asarray(tl).shape
        if list(shape) != list(ent["shape"]):
            raise ValueError(
                f"{path}: field {name} shape {tuple(ent['shape'])} != "
                f"template {shape}"
            )
        if _dtype_name(tl) != ent["dtype"]:
            raise ValueError(
                f"{path}: field {name} dtype {ent['dtype']} != "
                f"template {_dtype_name(tl)}"
            )
    return _unflatten(template, iter(leaves))


_PROBLEM_FIELDS = ("A", "B", "Q", "R", "u_min", "u_max", "x_min", "x_max",
                   "Xref", "Uref")
_CACHE_FIELDS = ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "coeff_d2p")


def save_problem_cache(
    path: str | pathlib.Path, problem: Problem, cache: Cache,
    settings: Settings | None = None,
) -> None:
    """One-file bundle of a ready-to-solve problem (the runtime counterpart of
    the reference's generated workspace, codegen.cpp:322-479)."""
    arrays = {}
    for name in _PROBLEM_FIELDS:
        arrays[f"problem_{name}"] = _np(getattr(problem, name))
    for name in _CACHE_FIELDS:
        arrays[f"cache_{name}"] = _np(getattr(cache, name))
    if settings is not None:
        arrays["settings"] = np.asarray([
            float(settings.abs_pri_tol), float(settings.abs_dua_tol),
            float(settings.max_iter), float(settings.check_termination),
            float(settings.en_state_bound), float(settings.en_input_bound),
        ])
    manifest = {
        "format_version": FORMAT_VERSION,
        "type": "ProblemCacheBundle",
        "leaves": [
            {"name": k, "shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in arrays.items()
        ],
    }
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)


def load_problem_cache(
    path: str | pathlib.Path, *, device: Any = DEFAULT_DEVICE,
) -> tuple[Problem, Cache, Settings | None]:
    """Reconstruct (Problem, Cache, Settings) as float32 tensors on
    ``device``, with cross-field dim checks: missing fields, non-square A,
    or cache dims disagreeing with the dynamics all raise with the field
    named."""
    with np.load(path) as d:
        files = set(d.files)
        missing = [n for n in _PROBLEM_FIELDS if f"problem_{n}" not in files]
        missing += [n for n in _CACHE_FIELDS if f"cache_{n}" not in files]
        if missing:
            raise ValueError(f"{path}: missing fields {missing}")
        p = {n: d[f"problem_{n}"] for n in _PROBLEM_FIELDS}
        c = {n: d[f"cache_{n}"] for n in _CACHE_FIELDS}
        s = d["settings"] if "settings" in files else None
    nx, nu = p["B"].shape
    checks = {
        "problem_A": (p["A"].shape, (nx, nx)),
        "cache_Kinf": (c["Kinf"].shape, (nu, nx)),
        "cache_Pinf": (c["Pinf"].shape, (nx, nx)),
        "cache_Quu_inv": (c["Quu_inv"].shape, (nu, nu)),
        "cache_AmBKt": (c["AmBKt"].shape, (nx, nx)),
        "cache_coeff_d2p": (c["coeff_d2p"].shape, (nx, nu)),
    }
    for name, (got, want) in checks.items():
        if tuple(got) != want:
            raise ValueError(
                f"{path}: {name} shape {tuple(got)} inconsistent with "
                f"dynamics (nx={nx}, nu={nu} -> expected {want})"
            )
    settings = None
    if s is not None:
        if s.shape != (6,):
            raise ValueError(f"{path}: settings vector shape {s.shape} != (6,)")
        settings = Settings(
            abs_pri_tol=float(s[0]), abs_dua_tol=float(s[1]),
            max_iter=int(s[2]), check_termination=int(s[3]),
            en_state_bound=bool(s[4]), en_input_bound=bool(s[5]),
        )
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return (Problem(**{n: t(a) for n, a in p.items()}),
            Cache(**{n: t(a) for n, a in c.items()}), settings)
