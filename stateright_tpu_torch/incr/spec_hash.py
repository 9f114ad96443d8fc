"""Per-component spec hashing for the incremental verification store.

The counterpart of ``stateright_tpu/incr/spec_hash.py``.  A verification
request is identified by five separately hashed components, so the store
can tell which part of a spec changed -- the classification the re-check
modes hang off:

- ``codec``      -- the transition machinery's code: packed widths, the
                    bytecode digests of ``encode`` / ``step`` and the
                    two-phase and boundary hooks, and a digest of the CUDA
                    sources the kernels build from (``csrc/``);
- ``constants``  -- the model's data (``CompiledModel.spec_constants``)
                    and the packed init states;
- ``properties`` -- property names, expectations, the bytecode digests of
                    the host conditions and of ``property_conds``, and the
                    ``csrc/`` digest again (the conds kernels live there);
- ``symmetry``   -- off, or the canon spec's digest;
- ``bounds``     -- target depth / state count and the finish_when policy.

An ``engine`` hash (engine name and kwargs) is recorded as evidence and
excluded from every matching decision: the engine's results do not depend
on its geometry, so a geometry-only change still hits the verdict cache.

The port's transition code is CUDA C++, which no Python bytecode digest
sees: an edit to ``csrc/twophase_step.cu`` would leave every method digest
equal.  So the codec and properties components fold a digest of every file
under ``csrc/``, sorted by name.  That is coarser than needed (an edit to
any kernel changes every model's hash, and a cold run follows), never
unsound.  ``expand`` and ``walk_step`` stay out of the codec digest: they
route the same kernels, and a model that overrides only ``property_conds``
must hash as its parent in codec and constants.

Everything is sha256 over canonically ordered bytes -- no ``hash()``, no
dict order -- so the hashes survive a fresh ``PYTHONHASHSEED``.  Bytecode
digests depend on the interpreter build, so the recipe folds in
``sys.implementation.cache_tag``: a store written by another Python reads
as cold, never as wrong.  ``HASH_VERSION`` is the port's own, so a store is
never shared with the JAX package (whose digests cover other code).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.model import Expectation

# Bump when the recipe changes: old entries then classify as cold (another
# spec_key), never as a false hit.
HASH_VERSION = "incr-spec-v1-torch-cuda"

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _stable_repr(v) -> str:
    """A ``PYTHONHASHSEED``-independent rendering of one constant-like
    value: sets fold sorted, nested code objects as their digest, opaque
    objects as their type only (their data is the constants component's,
    and an identity repr would leak an address)."""
    if isinstance(v, (frozenset, set)):
        return "{" + ",".join(sorted(_stable_repr(x) for x in v)) + "}"
    if isinstance(v, tuple):
        return "(" + ",".join(_stable_repr(x) for x in v) + ")"
    if isinstance(v, dict):
        return "{" + ",".join(sorted(
            f"{_stable_repr(k)}:{_stable_repr(x)}" for k, x in v.items()
        )) + "}"
    if v is None or isinstance(v, (int, float, bool, str, bytes, complex)):
        return repr(v)
    if hasattr(v, "co_code"):  # a nested code object (a nested lambda)
        h = hashlib.sha256()
        _code_digest(h, v)
        return "code:" + h.hexdigest()
    return f"<{type(v).__qualname__}>"


def _code_digest(h, code) -> None:
    """Fold one code object into ``h``: opcodes, names and constants."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    h.update(repr(code.co_varnames).encode())
    for const in code.co_consts:
        h.update(_stable_repr(const).encode())


def code_digest(fn) -> str:
    """Stable digest of a function's behaviour: bytecode, referenced names,
    default arguments, captured closure values and, transitively, the code
    of module-level functions (and values of module-level primitives) it
    references by name.  An inherited method digests as its parent's.
    Helpers reached through an attribute (``self._helper``, ``module.fn``)
    do not fold; opaque closure cells and globals fold as their type."""
    h = hashlib.sha256()
    _fold_function(h, fn, set())
    return h.hexdigest()


def _fold_function(h, fn, seen) -> None:
    fn = getattr(fn, "__func__", fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        # Builtins and partials have no code object: their qualified name.
        h.update(repr(getattr(fn, "__qualname__", repr(fn))).encode())
        return
    if id(code) in seen:  # recursion among helpers
        return
    seen.add(id(code))
    _code_digest(h, code)
    h.update(_stable_repr(getattr(fn, "__defaults__", None) or ()).encode())
    h.update(_stable_repr(getattr(fn, "__kwdefaults__", None) or {}).encode())
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            contents = cell.cell_contents
        except ValueError:  # an empty cell
            h.update(b"<empty-cell>")
            continue
        if hasattr(contents, "__code__"):
            _fold_function(h, contents, seen)
        else:
            h.update(_stable_repr(contents).encode())
    # Referenced globals: functions fold their code, primitive constants
    # their value; classes and modules ride in by name alone (co_names).
    g = getattr(fn, "__globals__", None)
    if g is not None:
        for name in sorted(set(code.co_names)):
            if name not in g:
                continue
            v = g[name]
            if callable(v) and hasattr(v, "__code__"):
                _fold_function(h, v, seen)
            elif v is None or isinstance(
                v, (int, float, bool, str, bytes, complex, tuple, frozenset)
            ):
                h.update(_stable_repr(v).encode())


def csrc_digest(root: Optional[Path] = None) -> str:
    """sha256 over every file of the kernel sources (``csrc/``), by sorted
    name: what the port's kernels are built from."""
    root = Path(CSRC if root is None else root)
    h = hashlib.sha256()
    for path in sorted(p for p in root.iterdir() if p.is_file()):
        h.update(path.name.encode())
        h.update(b"\x00")
        h.update(hashlib.sha256(path.read_bytes()).digest())
    return h.hexdigest()


def _hexdigest(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


def _method_digests(cm, names) -> str:
    out = []
    for name in names:
        fn = getattr(type(cm), name, None)
        out.append(f"{name}={'-' if fn is None else code_digest(fn)}")
    return ";".join(out)


class SpecFingerprint:
    """The hashed identity of one verification request.

    Attributes:
        components: component name -> hex digest.
        spec_key: content address of the full spec (engine excluded).
        family_key: codec + symmetry + bounds, the grouping under which
            property-only and constant-widening relatives are sought.
        constants: the raw ``spec_constants()`` dict (None when the model
            declares none; every reuse path then refuses).
        property_names / expectations: the property list, in order.
        has_eventually: whether any property is EVENTUALLY (the re-eval and
            seeding modes refuse those).
        snapshot_key: the engine-snapshot key a stored run must carry for
            its snapshot to seed this spec.
    """

    def __init__(self, model, compiled=None, symmetry: bool = False,
                 target_max_depth: Optional[int] = None,
                 target_state_count: Optional[int] = None,
                 finish_when=None, engine: str = "gpu",
                 engine_kwargs: Optional[dict] = None):
        from ..parallel.compiled import compiled_model_for
        from ..parallel.wavefront import snapshot_engine_key

        cm = compiled or compiled_model_for(model)
        self.model = model
        self.compiled = cm
        self.model_label = type(cm).__qualname__
        props = model.properties()
        self.property_names = [p.name for p in props]
        self.expectations = [p.expectation.name for p in props]
        self.has_eventually = any(
            p.expectation is Expectation.EVENTUALLY for p in props
        )
        self.symmetry = bool(symmetry)
        self.engine = engine
        kernels = csrc_digest()

        codec = _hexdigest(
            HASH_VERSION,
            sys.implementation.cache_tag or "py",
            str(cm.state_width),
            str(cm.max_actions),
            str(cm.fp_words or 0),
            _method_digests(
                cm, ("encode", "step", "step_valid", "step_lane", "boundary"),
            ),
            kernels,
        )

        self.constants = cm.spec_constants()
        init_digest = hashlib.sha256(
            np.ascontiguousarray(cm.init_packed()).tobytes()
        ).hexdigest()
        if self.constants is None:
            constants = _hexdigest("unstable", init_digest)
        else:
            constants = _hexdigest(
                json.dumps(
                    {str(k): str(v) for k, v in self.constants.items()},
                    sort_keys=True,
                ),
                init_digest,
            )

        properties = _hexdigest(
            json.dumps([
                {"name": p.name, "expectation": p.expectation.name,
                 "condition": code_digest(p.condition)}
                for p in props
            ]),
            _method_digests(cm, ("property_conds",)),
            kernels,
        )

        if not symmetry:
            sym = _hexdigest("off")
        else:
            spec = cm.canon_spec()
            sym = _hexdigest(
                "on", repr(spec), _method_digests(cm, ("canon_rows",)),
            )

        fw_kind = getattr(finish_when, "_kind", "all")
        fw_names = sorted(getattr(finish_when, "_names", ()) or ())
        bounds = _hexdigest(
            str(target_max_depth or 0),
            str(target_state_count or 0),
            fw_kind,
            json.dumps(fw_names),
        )
        self.target_max_depth = target_max_depth
        self.target_state_count = target_state_count

        eng = _hexdigest(
            engine,
            json.dumps(
                {str(k): repr(v) for k, v in (engine_kwargs or {}).items()},
                sort_keys=True,
            ),
        )

        self.components = {
            "codec": codec,
            "constants": constants,
            "properties": properties,
            "symmetry": sym,
            "bounds": bounds,
            "engine": eng,
        }
        self.spec_key = _hexdigest(codec, constants, properties, sym, bounds)
        self.family_key = _hexdigest(codec, sym, bounds)
        self.snapshot_key = snapshot_engine_key(cm, props, symmetry)

    @classmethod
    def of_builder(cls, builder, compiled=None, engine: str = "gpu",
                   engine_kwargs: Optional[dict] = None) -> "SpecFingerprint":
        """Fingerprint a configured :class:`~..core.checker.CheckerBuilder`,
        so the hashed bounds are the ones the spawned engine runs with."""
        return cls(
            builder.model,
            compiled=compiled,
            symmetry=builder._symmetry is not None,
            target_max_depth=builder._target_max_depth,
            target_state_count=builder._target_state_count,
            finish_when=builder._finish_when,
            engine=engine,
            engine_kwargs=engine_kwargs,
        )
