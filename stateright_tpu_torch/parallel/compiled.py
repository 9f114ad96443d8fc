"""The compiled-model contract: what the GPU wavefront engine needs.

The counterpart of ``stateright_tpu/parallel/compiled.py``, batched by
construction (no ``vmap``): every device method takes a whole batch of
packed states ``int32[F, W]`` -- the ``uint32`` words of the JAX package as
int32 bit-views -- on the engine's device.

- a bit-packed state encoding: ``encode``/``decode`` form a bijection
  between host states and ``uint32[W]`` rows;
- ``step(states[F, W]) -> (nexts[F, A, W], valid[F, A])``: every one of the
  ``max_actions`` candidate successors with a validity mask;
- ``property_conds(states[F, W]) -> bool[F, P]``: every property condition,
  in the order of ``model.properties()``;
- ``boundary(states[N, W]) -> bool[N]``: the device half of the model's
  ``within_boundary``, or None for an unbounded model;
- ``expand(states)``: all three at once -- each lane's validity ANDed with
  its successor's boundary test, as the JAX ``wave_eval`` does before it
  counts the wave -- plus the encoding-overflow flag, which is what the
  engine calls each wave.  A model with a fused kernel overrides it;
- ``walk_step(states)``: what the device walk (``simulation_gpu.py``)
  calls each step -- the JAX ``step`` and ``property_conds`` with NO
  successor boundary (the walk tests the boundary of the state it stands
  on) and each state's encoding-overflow flag, ``bool[F]``, or None for a
  model whose encoding cannot overflow (the JAX ``step_flags``);
- ``canon_spec()``: the symmetric record block ``symmetry()`` reduces by
  (``canon.py``), or None for a model without one; ``canon_rows(rows[B,
  W])`` overrides it where the declarative spec cannot say enough;
- ``spec_constants()`` / ``spec_widens(old)``: the model's constants for
  the incremental store's spec hash, and whether they widen a prior run's
  (``incr/``);
- ``gang_key()`` and the ``gang_*`` hooks: a family of models that the gang
  wave (``fleet/gang.py``) runs K at a time in one dispatch, each job's
  constants a row of a ``consts int32[K, C]`` input.

Two-phase contract (optional; :func:`two_phase_capable`): an unbounded
model whose lanes are mostly invalid answers validity alone and builds
successors only for the lanes that survive compaction --

- ``step_valid(states[F, W]) -> valid[F, A]``, without successors;
- ``step_lane(states[F, W], v_orig[U], count) -> (nexts[U, W],
  flags[U])``: the successor of each compacted flat lane ``v_orig[j] =
  state * A + action`` for ``j < count`` (a device scalar), and its
  encoding-overflow flag (False past ``count``).  Its validity must agree
  with ``step_valid`` on every lane.

The host ``Model`` stays the oracle for path reconstruction.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.model import Model


class CompiledModel:
    """Device form of a :class:`Model`.  Subclass per model family.

    Attributes
    ----------
    model: the host oracle model.
    state_width: W, uint32 words per packed state.
    max_actions: A, action arity of :meth:`step`.
    fp_words: the identity prefix of a row (None = all W words).
    """

    model: Model
    state_width: int
    max_actions: int
    # How many leading words of a row are the state's identity: the
    # engine fingerprints ``row[:fp_words]`` (None = the whole row), so
    # trailing words carry data the host model leaves out of its hash
    # (raft's delivered messages and buffer, examples/raft.rs:39-56).
    # Rows equal on the prefix are one state, represented by the row
    # inserted first.
    fp_words: Optional[int] = None

    # --- host side -----------------------------------------------------------

    def init_packed(self) -> np.ndarray:
        """Packed init states, shape [num_init, W] uint32."""
        states = [s for s in self.model.init_states() if self.model.within_boundary(s)]
        return np.stack([self.encode(s) for s in states]).astype(np.uint32)

    def encode(self, state: Any) -> np.ndarray:
        """Host state -> uint32[W].  Must be injective."""
        raise NotImplementedError

    def decode(self, words: Sequence[int]) -> Any:
        """uint32[W] -> host state; inverse of :meth:`encode`."""
        raise NotImplementedError

    # --- device side ----------------------------------------------------------

    def step(self, states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """int32[F, W] -> (int32[F, A, W] successors, bool[F, A] valid).

        Invalid lanes may hold arbitrary words; the engine masks them."""
        raise NotImplementedError

    def property_conds(self, states: torch.Tensor) -> torch.Tensor:
        """int32[F, W] -> bool[F, P], in ``model.properties()`` order."""
        raise NotImplementedError

    def boundary(self, states: torch.Tensor) -> Optional[torch.Tensor]:
        """int32[N, W] -> bool[N], True for rows within the model's
        boundary; None (the default) for an unbounded model."""
        return None

    def expand(
        self, states: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``(nexts, valid, conds, step_flag)`` for one wave's states, the
        validity already ANDed with each successor's :meth:`boundary`.
        ``step_flag`` is a bool scalar tensor marking a successor that
        overflowed the packed encoding, or None for a model whose encoding
        cannot overflow."""
        nexts, valid = self.step(states)
        f, a, w = nexts.shape
        inside = self.boundary(nexts.view(f * a, w))
        if inside is not None:
            valid = valid & inside.view(f, a)
        return nexts, valid, self.property_conds(states), None

    def walk_step(
        self, states: torch.Tensor, plain: bool = False
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``(nexts, valid, conds, flag_rows)`` of the JAX ``step`` and
        ``property_conds`` for the device walk: no successor boundary, and
        ``flag_rows`` each state's encoding-overflow flag ``bool[F]`` (None
        for a model whose encoding cannot overflow).  ``plain`` runs the
        kernels' plain-torch twins on any device (the card's walk is held
        against them).  A model with a fused kernel overrides it."""
        nexts, valid = self.step(states)
        return nexts, valid, self.property_conds(states), None

    # --- symmetry canonicalization (canon.py) -------------------------------

    def canon_spec(self):
        """The declarative symmetry spec (:class:`~.canon.CanonSpec`):
        which row-word spans form the symmetric record block and which
        fields hold record indices.  None (the default): the model has no
        canonicalization, and ``symmetry()`` on ``spawn_gpu`` raises."""
        return None

    def canon_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """``int32[B, W] -> int32[B, W]``: a model's own canonicalization
        of each row, used in place of K15 over :meth:`canon_spec` when a
        subclass overrides it (``canon.make_canon``).  An override must be
        idempotent and apply only genuine symmetries of the model, or the
        reduction prunes reachable states."""
        raise NotImplementedError

    # --- persistent spec identity (incr/spec_hash.py) -------------------------

    def spec_constants(self) -> Optional[dict]:
        """The model's constants as a flat name -> repr dict: the
        ``constants`` component of the incremental store's spec hash (the
        data the kernels are launched with, apart from their code).  The
        default reads a dataclass model's fields; any other model returns
        None (no stable declaration), and the store then refuses every
        reuse path rather than risk two differently-parameterized models
        hashing alike."""
        import dataclasses

        if dataclasses.is_dataclass(self.model):
            return {
                f.name: repr(getattr(self.model, f.name))
                for f in dataclasses.fields(self.model)
            }
        return None

    def spec_widens(self, old_constants: dict) -> bool:
        """Whether this model's constants describe a monotone widening of
        the reachable set of a prior run at ``old_constants`` (same codec,
        every old state keeping its row and transitions, the boundary
        admitting a superset): then the store may seed a re-check from
        the prior reachable set.  Default False -- a per-model claim,
        never inferred."""
        return False

    # --- gang batching (fleet/gang.py) ----------------------------------------

    def gang_key(self) -> Optional[tuple]:
        """The family under which compiled models may be gang-batched: K
        jobs whose compiled models share a key run as one dispatch a wave
        over a leading jobs axis (``fleet/gang.py``).  Equal keys must launch
        identical kernels through the ``gang_*`` hooks, each instance's
        constants passed as data (never baked into the launch), so the key
        pins codec widths, action arity, property count and the hooks' code
        (the type).  None (the default): not gang-capable, the job runs
        solo."""
        return None

    def gang_constants(self) -> np.ndarray:
        """The model's constants as one uint32 vector: its row of the gang
        wave's ``consts`` input, the same length for every member of a
        family."""
        raise NotImplementedError

    def gang_step(self, states: torch.Tensor, consts: torch.Tensor):
        """:meth:`step` with the constants as data: ``(int32[K, F, W],
        int32[K, C]) -> (int32[K, F, A, W], bool[K, F, A])``, job ``j`` under
        ``consts[j]``.  Must equal ``step`` whenever ``consts[j]`` is the
        model's :meth:`gang_constants` -- the gang's parity with solo runs
        rests on it."""
        raise NotImplementedError

    def gang_property_conds(self, states: torch.Tensor,
                            consts: torch.Tensor) -> torch.Tensor:
        """:meth:`property_conds` with the constants as data: ``bool[K, F,
        P]``."""
        raise NotImplementedError

    def gang_boundary(self, states: torch.Tensor,
                      consts: torch.Tensor) -> Optional[torch.Tensor]:
        """:meth:`boundary` with the constants as data: ``(int32[K, N, W],
        int32[K, C]) -> bool[K, N]``; None (the default) for an unbounded
        model -- and it must match ``boundary``, or a gang explores another
        space than the solo run."""
        return None

    def gang_expand(self, states: torch.Tensor, consts: torch.Tensor, out=None):
        """What the gang wave launches: ``(nexts int32[K, F, A, W], valid
        bool[K, F, A], conds bool[K, F, P])``, the successors of
        :meth:`gang_step`, their validity ANDed with :meth:`gang_boundary`
        and the conds of :meth:`gang_property_conds`, written into ``out``
        (the wave's readback buffer) where it is given.  A gang-capable
        family overrides it with its fused gang kernel, and takes its conds
        from a subclass's ``gang_property_conds`` override instead of the
        kernel's (:func:`fused_conds`)."""
        raise NotImplementedError

    def widens_by(self, old_constants: dict, key: str) -> bool:
        """The usual :meth:`spec_widens`: ``old_constants`` names this
        model's constants, each equal to this model's but the integer
        ``key``, which is at most this model's."""
        mine = self.spec_constants()
        if mine is None or set(old_constants) != set(mine):
            return False
        try:
            old = int(str(old_constants[key]))
        except (TypeError, ValueError):
            return False
        return old <= int(mine[key]) and all(
            str(old_constants[k]) == mine[k] for k in mine if k != key
        )


def compiled_model_for(model: Model) -> CompiledModel:
    """Resolve the compiled form of ``model`` (its ``compiled()`` method)."""
    fn = getattr(model, "compiled", None)
    if fn is None:
        raise NotImplementedError(
            f"{type(model).__name__} has no compiled form; define "
            "compiled() returning a CompiledModel to use spawn_gpu()"
        )
    return fn()


def fused_conds(cm, owner: type, hook: str = "property_conds") -> bool:
    """Whether ``cm``'s property conds are the ones ``owner``'s fused step
    kernel writes: False where a subclass overrides ``owner``'s ``hook``
    (``property_conds``, or ``gang_property_conds`` for a gang kernel), whose
    fused entry points must then take their conds from that override."""
    return getattr(type(cm), hook) is getattr(owner, hook)


def override_conds(cm, states: torch.Tensor, plain: bool = False):
    """The conds of ``cm``'s ``property_conds`` override.  With ``plain``
    (the walk's plain reference) they come from the override's twins on a
    CPU copy, so the reference never launches a kernel under test."""
    if plain and states.device.type != "cpu":
        return cm.property_conds(states.cpu()).to(states.device)
    return cm.property_conds(states)


def two_phase_capable(cm) -> bool:
    """Whether the engine expands ``cm`` in two phases (the counterpart of
    the JAX ``wave_common.two_phase_capable``): it exposes ``step_valid``
    and ``step_lane`` AND is unbounded -- a boundary tests the successor
    row, which the validity screen does not build."""
    if not (hasattr(cm, "step_valid") and hasattr(cm, "step_lane")):
        return False
    probe = torch.zeros((1, cm.state_width), dtype=torch.int32)
    return cm.boundary(probe) is None
