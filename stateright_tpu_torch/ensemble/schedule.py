"""Per-member fault-schedule derivation — pure functions of the seed.

A copy of ``stateright_tpu/ensemble/schedule.py``.

An ensemble member is fully described by ``(base_seed, member index,
base ChaosSpec, step horizon)``: the member's 64-bit transport seed is a
splitmix64 finalizer of the base seed at counter ``member + 1``
(:func:`member_seed`), and its effective chaos spec scales every fault
rate of the base spec by per-member unit-interval factors drawn from
that seed (:func:`member_spec`).  Nothing is sampled statefully, so the
``ensemble_repro`` journal event — which records the member seed and the
*effective* spec — rebuilds the exact host transport schedule with no
reference to the ensemble run that found it (docs/CHAOS_ENSEMBLES.md,
"Repro artifact").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..runtime.chaos import (
    _MASK64,
    _SPLITMIX_GAMMA,
    ChaosSpec,
    LinkFaults,
    fault_fate_u32,
)

# Draw positions for the member-level parameters, on the member seed
# itself (link fate streams run on per-link seeds derived from it, so
# the streams never collide).  n=0 holds the four rate scales at the
# FATE_* slots; n=1 holds the device partition-window draws.
_N_SCALES = 0
_N_PARTITION = 1


def _splitmix64(z: int) -> int:
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def member_seed(base_seed: int, member: int) -> int:
    """The member's 64-bit transport seed: counter-mode splitmix64 over
    the base seed — the same generator family as the fate function, so
    the whole ensemble derives from one integer."""
    return _splitmix64(
        (int(base_seed) + (int(member) + 1) * _SPLITMIX_GAMMA) & _MASK64
    )


def _scales(seed: int) -> Tuple[float, float, float, float]:
    """Per-member rate multipliers (drop, reorder, duplicate, delay),
    each uniform in [0, 1) — the ensemble's intensity diversification."""
    return tuple(
        fault_fate_u32(seed, _N_SCALES, k) / 4294967296.0 for k in range(4)
    )


def _scale_faults(f: LinkFaults, s: Tuple[float, float, float, float]) -> LinkFaults:
    return LinkFaults(
        drop=f.drop * s[0],
        reorder=f.reorder * s[1],
        duplicate=f.duplicate * s[2],
        delay=(f.delay[0] * s[3], f.delay[1] * s[3]),
    )


def member_spec(base: ChaosSpec, seed: int) -> ChaosSpec:
    """The member's effective chaos spec: every rate (default and
    per-link overrides) scaled by the member's factors; partition
    *groups* pass through (their device step-windows are drawn
    separately — host windows stay wall-time, see partition_window)."""
    s = _scales(seed)
    return ChaosSpec(
        default=_scale_faults(base.default, s),
        links=tuple((k, _scale_faults(f, s)) for k, f in base.links),
        partitions=base.partitions,
    )


def partition_window(seed: int, steps: int) -> Tuple[int, int]:
    """The member's device partition window, in step units: a start in
    [0, steps) and a heal at start + [1, steps-start] (or -1 = never
    heals, when the second draw lands in its top eighth).  Host windows
    are wall-time and excluded from the host reproducibility guarantee,
    so the device sweep diversifies its own step-indexed windows
    instead."""
    steps = max(1, int(steps))
    w0 = fault_fate_u32(seed, _N_PARTITION, 0)
    w1 = fault_fate_u32(seed, _N_PARTITION, 1)
    at = w0 % steps
    if w1 >= (7 << 29):  # top eighth: permanent partition
        return at, -1
    return at, at + 1 + w1 % (steps - at)


@dataclass(frozen=True)
class EnsembleSchedule:
    """One member's complete, self-contained schedule description."""

    member: int
    seed: int  # the member's 64-bit transport seed
    spec: ChaosSpec  # the member's EFFECTIVE (scaled) spec
    steps: int  # walk horizon (and shrink dimension)
    partition_at: int = -1  # device window, step units (-1: no window)
    partition_heal: int = -1

    def to_repro(self) -> dict:
        """The ``ensemble_repro`` payload: everything a later process
        needs to rebuild the host transport schedule, with no reference
        to the run that found it."""
        return {
            "member": self.member,
            "seed": self.seed,
            "spec": self.spec.to_dict(),
            "steps": self.steps,
            "partition_at": self.partition_at,
            "partition_heal": self.partition_heal,
        }

    @staticmethod
    def from_repro(d: dict) -> "EnsembleSchedule":
        return EnsembleSchedule(
            member=int(d["member"]),
            seed=int(d["seed"]),
            spec=ChaosSpec.from_json(d["spec"]),
            steps=int(d["steps"]),
            partition_at=int(d.get("partition_at", -1)),
            partition_heal=int(d.get("partition_heal", -1)),
        )


def derive_schedule(
    base_seed: int,
    member: int,
    base_spec: Optional[ChaosSpec],
    steps: int,
) -> EnsembleSchedule:
    """Member ``member``'s schedule — THE pure function the whole
    subsystem leans on: same (base_seed, member, base spec, steps),
    same schedule, on every host and every run."""
    base_spec = base_spec if base_spec is not None else ChaosSpec()
    seed = member_seed(base_seed, member)
    at, heal = (
        partition_window(seed, steps) if base_spec.partitions else (-1, -1)
    )
    return EnsembleSchedule(
        member=member,
        seed=seed,
        spec=member_spec(base_spec, seed),
        steps=int(steps),
        partition_at=at,
        partition_heal=heal,
    )
