"""Consistency semantics: the register spec and the linearizability tester
the register harness records into.  Reference: src/semantics.rs."""

from .consistency import LinearizabilityTester
from .register import READ, WRITE_OK, ReadOk, ReadOp, Register, WriteOk, WriteOp
from .spec import SequentialSpec

__all__ = [
    "LinearizabilityTester", "READ", "WRITE_OK", "ReadOk", "ReadOp",
    "Register", "SequentialSpec", "WriteOk", "WriteOp",
]
