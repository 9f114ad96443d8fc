"""Chaos specifications and the fault-fate function, host side.

The spec half of ``stateright_tpu/runtime/chaos.py``, copied so the port
needs nothing of the JAX package: the per-datagram fate function
(:func:`fault_fate_u32`, counter-mode splitmix64 over a per-link seed),
the :class:`ChaosSpec` parser with its link faults and partition windows,
and the per-link seed :func:`_link_rng_seed`.  The chaos-ensemble engine
(``ensemble/``) derives each member's schedule from them, and its device
fate kernel (K19, ``csrc/fate.cu``) evaluates :func:`fault_fate_u32` at the
same counter positions.

The transport half -- ``FaultyTransport``, ``RecordingTransport``,
``LiveAuditor`` and ``run_chaos_register_system`` -- needs the UDP actor
runtime, which the port does not have yet, so a failing ensemble member
cannot be replayed on the host here.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

from ..actor.ids import Id

_MASK64 = (1 << 64) - 1

# The four per-datagram draws, in their fixed order (the schedule for
# datagram n must never shift with timing): drop, reorder, duplicate,
# delay.  The indices are shared with the device fate kernel
# (ensemble/fate.py), which evaluates the same counter positions.
FATE_DROP, FATE_REORDER, FATE_DUPLICATE, FATE_DELAY = range(4)
FATE_DRAWS = 4

_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15


def fault_fate_u32(link_seed: int, n: int, k: int) -> int:
    """The fate word: a uniform uint32 deciding draw ``k`` (one of the
    four ``FATE_*`` positions) for the ``n``-th datagram on the link
    whose seed is ``link_seed`` (:func:`_link_rng_seed`).

    Counter-mode splitmix64 — the finalizer evaluated at counter
    ``4n + k + 1`` over the link seed, top 32 bits kept.  There is no
    sequential generator state, so the same function is implementable
    as uint32 limb arithmetic inside a vmapped device step
    (``ensemble/fate.py``) and matches this transport bit-for-bit:
    the load-bearing bridge that lets a device-found failing fault
    schedule replay exactly in the host transport."""
    z = (int(link_seed) + (4 * int(n) + int(k) + 1) * _SPLITMIX_GAMMA) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z = z ^ (z >> 31)
    return z >> 32


def fault_draws(link_seed: int, n: int) -> Tuple[float, float, float, float]:
    """The four unit-interval draws ``(drop, reorder, duplicate,
    delay)`` for datagram ``n``: each is ``fate / 2**32`` — exact in
    float64 — so the host comparison ``draw < rate`` is bit-equivalent
    to the device threshold compare ``fate < ceil(rate * 2**32)``
    (``ensemble/fate.py.rate_threshold`` proves the rounding out)."""
    return (
        fault_fate_u32(link_seed, n, FATE_DROP) / 4294967296.0,
        fault_fate_u32(link_seed, n, FATE_REORDER) / 4294967296.0,
        fault_fate_u32(link_seed, n, FATE_DUPLICATE) / 4294967296.0,
        fault_fate_u32(link_seed, n, FATE_DELAY) / 4294967296.0,
    )


# --- chaos specification -----------------------------------------------------


@dataclass(frozen=True)
class LinkFaults:
    """Per-directed-link fault probabilities (each decided per datagram)."""

    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    delay: Tuple[float, float] = (0.0, 0.0)  # uniform seconds (lo, hi)


@dataclass(frozen=True)
class Partition:
    """A timed partition window: links crossing group boundaries drop all
    datagrams while ``at <= elapsed < heal`` (``heal=None``: forever)."""

    at: float
    heal: Optional[float]
    groups: Tuple[FrozenSet[int], ...]

    def cuts(self, src: int, dst: int, elapsed: float) -> bool:
        if elapsed < self.at or (self.heal is not None and elapsed >= self.heal):
            return False
        src_g = dst_g = None
        for i, g in enumerate(self.groups):
            if src in g:
                src_g = i
            if dst in g:
                dst_g = i
        return src_g is not None and dst_g is not None and src_g != dst_g


_FAULT_KEYS = ("drop", "duplicate", "reorder", "delay")


def _parse_faults(d: dict, where: str) -> LinkFaults:
    if not isinstance(d, dict):
        raise ValueError(
            f"chaos {where} must be an object of fault rates: {d!r}"
        )
    unknown = set(d) - set(_FAULT_KEYS)
    if unknown:
        raise ValueError(f"unknown chaos fault key(s) in {where}: {sorted(unknown)}")
    rates = {}
    for k in ("drop", "duplicate", "reorder"):
        v = d.get(k, 0.0)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or not (0.0 <= v <= 1.0):
            raise ValueError(f"chaos {where}.{k} must be a probability in [0, 1]: {v!r}")
        rates[k] = float(v)
    delay = d.get("delay", (0.0, 0.0))
    if isinstance(delay, (int, float)) and not isinstance(delay, bool):
        delay = (float(delay), float(delay))
    try:
        lo, hi = (float(delay[0]), float(delay[1]))
    except (TypeError, ValueError, IndexError):
        raise ValueError(
            f"chaos {where}.delay must be seconds or [lo, hi]: {delay!r}"
        ) from None
    if lo < 0 or hi < lo:
        raise ValueError(f"chaos {where}.delay must satisfy 0 <= lo <= hi: {delay!r}")
    return LinkFaults(delay=(lo, hi), **rates)


def _parse_partition(p, where: str) -> Partition:
    """One partition window; every malformed shape raises a single
    ``ValueError`` naming the offending key path (``partitions[i].at``
    etc.), never a raw ``KeyError``/``TypeError``."""
    if not isinstance(p, dict):
        raise ValueError(f"chaos {where} must be an object: {p!r}")
    unknown = set(p) - {"at", "heal", "groups"}
    if unknown:
        raise ValueError(
            f"unknown chaos key(s) in {where}: {sorted(unknown)}"
        )
    missing = [k for k in ("at", "groups") if k not in p]
    if missing:
        raise ValueError(
            f"chaos {where} needs {'/'.join(missing)} "
            f"(at/groups + optional heal): {p!r}"
        )
    try:
        at = float(p["at"])
    except (TypeError, ValueError):
        raise ValueError(
            f"chaos {where}.at must be seconds: {p['at']!r}"
        ) from None
    try:
        heal = None if p.get("heal") is None else float(p["heal"])
    except (TypeError, ValueError):
        raise ValueError(
            f"chaos {where}.heal must be seconds or null: {p['heal']!r}"
        ) from None
    raw_groups = p["groups"]
    if not isinstance(raw_groups, (list, tuple)):
        raise ValueError(
            f"chaos {where}.groups must be an array of id arrays: "
            f"{raw_groups!r}"
        )
    groups = []
    for j, g in enumerate(raw_groups):
        if not isinstance(g, (list, tuple)):
            raise ValueError(
                f"chaos {where}.groups[{j}] must be an array of actor "
                f"ids: {g!r}"
            )
        try:
            groups.append(frozenset(int(x) for x in g))
        except (TypeError, ValueError):
            raise ValueError(
                f"chaos {where}.groups[{j}] must contain integer actor "
                f"ids: {g!r}"
            ) from None
    if heal is not None and heal < at:
        raise ValueError(f"chaos {where}: heal < at: {p!r}")
    return Partition(at, heal, tuple(groups))


@dataclass(frozen=True)
class ChaosSpec:
    """Parsed chaos spec: default link faults, per-link overrides, and
    partition windows.  JSON schema (docs/ACTORS.md):

    ``{"drop": 0.1, "duplicate": 0.05, "reorder": 0.1, "delay": [0, 0.02],
    "links": {"0->1": {"drop": 0.5}},
    "partitions": [{"at": 0.5, "heal": 1.5, "groups": [[0, 1], [2]]}]}``

    Fault keys may be given at top level (the default for every link) or
    under ``"default"``; ``"links"`` keys are ``"SRC->DST"`` actor ids.
    """

    default: LinkFaults = field(default_factory=LinkFaults)
    links: Tuple[Tuple[Tuple[int, int], LinkFaults], ...] = ()
    partitions: Tuple[Partition, ...] = ()

    @staticmethod
    def from_json(obj) -> "ChaosSpec":
        if isinstance(obj, (str, bytes)):
            obj = json.loads(obj)  # JSONDecodeError is a ValueError
        if obj is None:
            return ChaosSpec()
        if not isinstance(obj, dict):
            raise ValueError(f"chaos spec must be a JSON object: {obj!r}")
        known = set(_FAULT_KEYS) | {"default", "links", "partitions"}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown chaos spec key(s): {sorted(unknown)}")
        top = {k: obj[k] for k in _FAULT_KEYS if k in obj}
        if top and "default" in obj:
            raise ValueError(
                "chaos spec: give fault rates at top level OR under "
                '"default", not both'
            )
        default = _parse_faults(top or obj.get("default", {}) or {}, "default")
        links_obj = obj.get("links") or {}
        if not isinstance(links_obj, dict):
            raise ValueError(
                'chaos links must be an object of "SRC->DST" keys: '
                f"{links_obj!r}"
            )
        links = []
        for key, d in links_obj.items():
            try:
                src_s, dst_s = str(key).split("->")
                link = (int(src_s), int(dst_s))
            except ValueError:
                raise ValueError(
                    f'chaos links key must look like "SRC->DST": {key!r}'
                ) from None
            links.append((link, _parse_faults(d or {}, f"links[{key}]")))
        parts_obj = obj.get("partitions") or ()
        if not isinstance(parts_obj, (list, tuple)):
            raise ValueError(
                f"chaos partitions must be an array: {parts_obj!r}"
            )
        partitions = []
        for i, p in enumerate(parts_obj):
            partitions.append(_parse_partition(p, f"partitions[{i}]"))
        return ChaosSpec(
            default=default,
            links=tuple(sorted(links)),
            partitions=tuple(partitions),
        )

    def remap_ids(self, mapping: Dict[int, int]) -> "ChaosSpec":
        """Rewrite link and partition-group ids through ``mapping`` —
        specs are written with model indices (0, 1, 2, …), but over UDP
        the actors' real ids are socket-addr encodings, which would
        silently never match (ids absent from the mapping pass through
        unchanged)."""

        def m(x: int) -> int:
            return mapping.get(x, x)

        return ChaosSpec(
            default=self.default,
            links=tuple(
                sorted(((m(s), m(d)), f) for (s, d), f in self.links)
            ),
            partitions=tuple(
                Partition(
                    p.at, p.heal, tuple(frozenset(m(x) for x in g) for g in p.groups)
                )
                for p in self.partitions
            ),
        )

    def faults_for(self, src: Id, dst: Id) -> LinkFaults:
        link = (int(src), int(dst))
        for k, f in self.links:
            if k == link:
                return f
        return self.default

    def to_dict(self) -> dict:
        def faults(f: LinkFaults) -> dict:
            return {
                "drop": f.drop, "duplicate": f.duplicate,
                "reorder": f.reorder, "delay": list(f.delay),
            }

        return {
            "default": faults(self.default),
            "links": {f"{s}->{d}": faults(f) for (s, d), f in self.links},
            "partitions": [
                {
                    "at": p.at,
                    "heal": p.heal,
                    "groups": [sorted(g) for g in p.groups],
                }
                for p in self.partitions
            ],
        }


def _link_rng_seed(seed: int, src: Id, dst: Id) -> int:
    """A stable 64-bit per-link seed: fault schedules depend only on
    (seed, src, dst, per-link datagram index), never on hash
    randomization, thread interleaving, or wall time."""
    h = (int(seed) & _MASK64) * 0x9E3779B97F4A7C15
    h = (h + (int(src) + 1) * 0xC2B2AE3D27D4EB4F) & _MASK64
    h = (h + (int(dst) + 1) * 0x165667B19E3779F9) & _MASK64
    return h
