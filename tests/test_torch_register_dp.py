"""The port's linearizability DP against the JAX package, on the CPU.

``device_linearizable_plain`` (the plain-torch twin of the DP inside the
K6 and K9 kernels, ``csrc/register_lin.cuh``) against the JAX
``RegisterClientCodec.device_linearizable`` at every client count the
register harness takes, C = 1..7: on 256 seeded rows (128 of raw words,
128 of consistent tester states) and on hand-made histories -- completed
violations and operations still in flight.  Bit-equal per row.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.models.register_compiled_common import (  # noqa: E402
    RegisterClientCodec as JaxRegisterClientCodec,
)
from stateright_tpu_torch.models.register_compiled_common import (  # noqa: E402
    RegisterClientCodec,
    device_linearizable_plain,
)
from stateright_tpu_torch.ops.u32 import from_numpy_u32, u32  # noqa: E402

# A layout with the tester words first: word 0 the client word, then C
# tester words (the DP reads only those).
CLI, TST0 = 0, 1


def _word(c, phase, lc_w=0, lc_r=0, value=0):
    """A tester word: phase | write snapshot | read snapshot | read value."""
    lcb = 2 * (c - 1)
    return phase | (lc_w << 3) | (lc_r << (3 + lcb)) | (value << (3 + 2 * lcb))


def _snapshot(c, me, counts):
    """The snapshot code of client ``me`` for completed-op counts per client."""
    bits, slot = 0, 0
    for j in range(c):
        if j != me:
            bits |= counts[j] << (2 * slot)
            slot += 1
    return bits


def _consistent(c, rng, n):
    """Tester states a run could hold: per client a phase 0..4, a read
    snapshot no larger than the other clients' completed counts, a read
    value 0..C."""
    rows = np.zeros((n, 1 + c), np.uint32)
    for r in range(n):
        phases = rng.integers(0, 5, c)
        counts = [(p >= 2) + (p == 4) for p in phases]
        for i in range(c):
            seen = [int(rng.integers(0, counts[j] + 1)) for j in range(c)]
            lc_r = _snapshot(c, i, seen) if phases[i] >= 3 else 0
            value = int(rng.integers(0, c + 1)) if phases[i] == 4 else 0
            rows[r, TST0 + i] = _word(c, int(phases[i]), lc_r=lc_r, value=value)
    return rows


def _hand_made(c):
    """Histories with a known answer, each padded with idle clients.

    - every client's write and read done, each read invoked after every
      write completed and returning client C-1's value: linearizable;
    - client 0 reads NULL after its own write completed: not;
    - client 0's read and the other clients' writes in flight, then every
      write in flight: linearizable;
    - from C = 2: client 0 reads client 1's value though client 1 never
      invoked its write: not;
    - client 0 reads its own value after a snapshot that saw client 1's
      write and read completed, and client 1 read client 0's value:
      linearizable, with client 0's write ordered after client 1's;
    - client 1 reads NULL after seeing client 0's write completed: not."""
    rows = []

    def row(words):
        r = np.zeros(1 + c, np.uint32)
        r[TST0 : TST0 + len(words)] = words
        return r

    rows.append(row([
        _word(c, 4, lc_r=_snapshot(c, i, [1] * c), value=c) for i in range(c)
    ]))
    rows.append(row([_word(c, 4, value=0)]))
    rows.append(row([_word(c, 3)] + [_word(c, 1)] * (c - 1)))
    rows.append(row([_word(c, 1)] * c))
    if c >= 2:
        rows.append(row([_word(c, 4, value=2)]))
        seen1 = [0, 2] + [0] * (c - 2)
        rows.append(row([
            _word(c, 4, lc_r=_snapshot(c, 0, seen1), value=1),
            _word(c, 4, value=1),
        ]))
        seen0 = [1] + [0] * (c - 1)
        rows.append(row([_word(c, 2), _word(c, 4, lc_r=_snapshot(c, 1, seen0))]))
    return np.stack(rows)


@pytest.mark.parametrize("c", range(1, 8))
def test_dp_twin_matches_jax(c):
    rng = np.random.default_rng(1000 + c)
    raw = rng.integers(0, 2**32, size=(128, 1 + c), dtype=np.uint64).astype(np.uint32)
    hand = _hand_made(c)
    rows = np.concatenate([raw, _consistent(c, rng, 128), hand])
    jax_rc = JaxRegisterClientCodec(1, c, CLI, TST0)
    want = np.asarray(jax.jit(jax.vmap(jax_rc.device_linearizable))(jnp.asarray(rows)))
    got = device_linearizable_plain(
        RegisterClientCodec(1, c, CLI, TST0), u32(from_numpy_u32(rows, "cpu"))
    ).numpy()
    assert np.array_equal(got, want)
    # The hand-made answers, and both verdicts present in each set.
    expect = [True, False, True, True] + ([False, True, False] if c >= 2 else [])
    assert got[-len(hand):].tolist() == expect
    assert want[:128].any() and not want[:128].all()
    assert want[128:256].any() and not want[128:256].all()
