"""The port's JAX threefry stream (``ops/prng.py``) against ``jax.random``.

Bit-equal on about a thousand seeded keys: ``PRNGKey``, ``fold_in`` (data
at and above 2**31), ``split`` and ``randint`` (maxval 1 to 64, and the
edges 0, 2**31 - 1, 2**31 and 2**32 - 1 of a uint32 bound).
The JAX version and configuration the stream transcribes are asserted, so
an upgrade that changes them fails here first.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from stateright_tpu_torch.ops import prng  # noqa: E402
from stateright_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32  # noqa: E402

N = 1000


@pytest.fixture(scope="module")
def keys():
    """JAX keys of 1,000 seeds in [0, 2**32) and the port's."""
    seeds = np.random.default_rng(0).integers(0, 1 << 32, N)
    j = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds.astype(np.uint32)))
    return np.asarray(j), prng.prng_key(torch.tensor(seeds))


@pytest.mark.parametrize("name", sorted(prng.JAX_CONFIG))
def test_jax_configuration_is_the_transcribed_one(name):
    assert jax.__version__ == prng.JAX_VERSION
    assert getattr(jax.config, name) == prng.JAX_CONFIG[name]


@pytest.mark.parametrize("seed", [0, 3, 7, (1 << 31) - 1, 1 << 31, (1 << 32) - 1,
                                  (1 << 32) + 5, -1, -5])
def test_prng_key_matches_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert (to_numpy_u32(prng.prng_key(seed))[0] == want).all()


def test_prng_key_batch_matches_jax(keys):
    j, p = keys
    assert (to_numpy_u32(p) == j).all()


@pytest.mark.parametrize("lo,hi", [(0, 1 << 16), (1 << 31, 1 << 32), (0, 1 << 32)])
def test_fold_in_matches_jax(keys, lo, hi):
    j, p = keys
    data = np.random.default_rng(lo & 0xFF).integers(lo, hi, N).astype(np.uint32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(j), jnp.asarray(data)))
    got = prng.fold_in(p, torch.tensor(data.astype(np.int64)))
    assert (to_numpy_u32(got) == want).all()


def test_split_matches_jax(keys):
    j, p = keys
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(j)))
    key, sub = prng.split(p)
    assert (to_numpy_u32(key) == want[:, 0]).all()
    assert (to_numpy_u32(sub) == want[:, 1]).all()


@pytest.mark.parametrize("maxvals", ["1..64", "edges"])
def test_randint_matches_jax(keys, maxvals):
    """The walk's draw: ``randint(key, (), 0, maxval)`` with a uint32
    bound, dtype int32 -- every bound from 1 to 64, and the bounds where
    JAX's span arithmetic changes (0, the int32 edge, past it)."""
    j, p = keys
    if maxvals == "1..64":
        mx = np.arange(N) % 64 + 1
    else:
        mx = np.resize([0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 31) + 7,
                        (1 << 32) - 1], N)
    mx = mx.astype(np.uint32)
    want = np.asarray(jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m))(
        jnp.asarray(j), jnp.asarray(mx)))
    got = prng.randint(p, torch.tensor(mx.astype(np.int64)))
    assert got.dtype == torch.int32
    assert (got.numpy() == want).all()


def test_walk_draw_chain_matches_jax(keys):
    """The checker's chain: ``fold_in(fold_in(PRNGKey(seed), round), w)``,
    then each step's ``key, sub = split(key)`` and ``randint(sub, v)``."""
    seed, rnd = 3, 2
    base = jax.random.PRNGKey(seed)
    jk = jax.vmap(lambda w: jax.random.fold_in(jax.random.fold_in(base, rnd), w))(
        np.arange(256))
    pk = prng.fold_in(prng.fold_in(prng.prng_key(seed), rnd).expand(256, 2),
                      torch.arange(256))
    assert (to_numpy_u32(pk) == np.asarray(jk)).all()
    for v in (1, 5, 36):
        js = jax.vmap(jax.random.split)(jk)
        jk, jsub = js[:, 0], js[:, 1]
        jj = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, jnp.uint32(v)))(jsub))
        pk, psub = prng.split(pk)
        assert (prng.randint(psub, v).numpy() == jj).all()
    assert (to_numpy_u32(pk) == np.asarray(jk)).all()


def test_keys_are_int32_bit_views():
    k = prng.prng_key(0xFFFFFFFF)
    assert k.dtype == torch.int32 and tuple(k.shape) == (1, 2)
    assert to_numpy_u32(k).tolist() == [[0, 0xFFFFFFFF]]
    assert torch.equal(from_numpy_u32(to_numpy_u32(k), "cpu"), k)
