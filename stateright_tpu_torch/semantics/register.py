"""Register operational semantics.

Reference: src/semantics/register.rs.  Ops are ``WriteOp(v)`` / ``ReadOp``;
returns are ``WriteOk`` / ``ReadOk(v)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

from .spec import SequentialSpec


@dataclass(frozen=True)
class WriteOp:
    value: Any


@dataclass(frozen=True)
class ReadOp:
    pass


READ = ReadOp()


@dataclass(frozen=True)
class WriteOk:
    pass


WRITE_OK = WriteOk()


@dataclass(frozen=True)
class ReadOk:
    value: Any


class Register(SequentialSpec):
    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def invoke(self, op):
        if isinstance(op, WriteOp):
            self.value = op.value
            return WRITE_OK
        if isinstance(op, ReadOp):
            return ReadOk(self.value)
        raise TypeError(f"unknown op {op!r}")

    def is_valid_step(self, op, ret) -> bool:
        if isinstance(op, WriteOp) and isinstance(ret, WriteOk):
            self.value = op.value
            return True
        if isinstance(op, ReadOp) and isinstance(ret, ReadOk):
            return self.value == ret.value
        return False

    def clone(self) -> "Register":
        return Register(self.value)

    def __eq__(self, other) -> bool:
        return isinstance(other, Register) and self.value == other.value

    def __hash__(self) -> int:
        return hash(("Register", self.value))

    def __repr__(self) -> str:
        return f"Register({self.value!r})"

    def __canon_words__(self, out: List[int]) -> None:
        from ..ops.fingerprint import canon_words

        canon_words(("Register", self.value), out)
